// phylonium-tpu native host library.
//
// Host-side compute for the TPU-native distance engine: suffix-array
// construction (SA-IS), longest-prefix-match queries, and the anchor
// chaining state machine.  This replaces the role of the reference's
// libdivsufsort + ESA machinery (reference: phylonium's src/esa.cxx)
// with an independent implementation built around a k-mer bucketed
// binary search; results are behaviorally identical (same longest-match
// spec) and are cross-checked against the numpy oracle in tests.
//
// Exposed as a C ABI consumed via ctypes (phylonium_tpu/native/__init__.py).
//
// SPDX-License-Identifier: MIT

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <type_traits>
#include <utility>
#include <vector>

#if defined(__SSSE3__)
#include <immintrin.h>
#endif

#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
#else
#include <thread>
#endif

#ifdef _OPENMP
#include <omp.h>
#else
static double omp_get_wtime() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}
#endif

using i64 = int64_t;
using u8 = uint8_t;

// ---------------------------------------------------------------------------
// SA-IS suffix array construction (Nong, Zhang & Chan 2009), written from
// scratch.  Sorts suffixes in plain byte-lexicographic order where a suffix
// that is a proper prefix of a longer one sorts first — the same order
// libdivsufsort produces for the reference.
//
// Parallel under OpenMP, and the same algorithm on one thread:
// - each position's L/S type lives in the top bit of its symbol, so one
//   load gives both T[j-1] and its type;
// - the induce passes put every entry in the slot the serial scan would:
//   at the text's level bucket by bucket, each wave of a bucket split
//   across the threads by per-thread counts (induce_waves); at a
//   recursion's, in blocks of the SA, as Grebnov's libsais does: the
//   threads gather what each entry induces, with software prefetch, one
//   places, the threads scatter (induce_blocks);
// - the linear stages (classify, bucket counts, LMS placement and
//   collection, naming, the reduced string) split into chunks with exact
//   boundary fix-ups;
// - a level runs in two parallel regions whose threads meet at a barrier
//   that sleeps soon (Barrier), so a build beside other busy threads
//   does not wait on OpenMP's spinning;
// - names live in the free half of the SA, the reduced string at its end,
//   and the recursion sorts into its first n1 entries: no n-sized array
//   beyond the text and the SA.
// The suffix array is unique, so every thread count gives the same one.
// ---------------------------------------------------------------------------

namespace {

// A vector whose elements start uninitialised: the build fills every
// entry itself, in parallel, so the serial zero-fill is wasted work.
template <typename T>
struct NoInit : std::allocator<T> {
    template <typename U>
    struct rebind {
        using other = NoInit<U>;
    };
    NoInit() = default;
    template <typename U>
    NoInit(const NoInit<U> &) {}
    template <typename U>
    void construct(U *p) {
        ::new ((void *)p) U;
    }
    template <typename U, typename... A>
    void construct(U *p, A &&...a) {
        ::new ((void *)p) U(std::forward<A>(a)...);
    }
};
template <typename T>
using Buf = std::vector<T, NoInit<T>>;

#ifndef _OPENMP
static int omp_get_thread_num() { return 0; }
static int omp_get_max_threads() { return 1; }
#endif

// Levels shorter than this run on one thread: about here the threads'
// start and barriers cost what they save (8 threads of a Xeon against
// one: 1.45 against 2.13 ms at 16,384 random bases, 5.5 against 9.3 ms at
// 65,536).
constexpr i64 PAR_MIN_N = 1 << 14;

// Symbols at most this many: per-thread counts by symbol (bucket_counts,
// place_lms); more, a recursion's names: other means.
constexpr i64 FEW_SYMBOLS = 65536;
// Symbols at most this many: induce_waves, else induce_blocks (a
// recursion's names make buckets of a few entries each).
constexpr i64 INDUCE_WAVES_K = 1024;
// Entries of a block of induce_blocks: its cache of 512 KiB stays in a
// core's L2 (8 threads of a Xeon, a 4.7 Mbp genome's doubled text: 0.44
// s a build, 0.55 s at 2^18 entries, 0.74 s at 2^20).
constexpr i64 INDUCE_BLOCK = 1 << 16;

struct SaisCtx {
    int threads = 1;  // threads of the levels at or above PAR_MIN_N
    int depth = 0;    // the level now running (1 = the text)
    int levels = 0;   // the deepest level that ran
    int threads_for(i64 n) const { return n >= PAR_MIN_N ? threads : 1; }
};

// thread t's share [*a, *b) of [lo, hi)
inline void chunk(i64 lo, i64 hi, int t, int nt, i64 *a, i64 *b) {
    *a = lo + (hi - lo) * t / nt;
    *b = lo + (hi - lo) * (t + 1) / nt;
}

// A barrier for the threads of one parallel region.  A thread that comes
// early spins for some microseconds, then sleeps on a futex.  OpenMP's
// own barriers spin for milliseconds: where other work holds some cores
// (a reader, a shipper or the device's warm-up beside the index), a
// thread that lost its core waits behind the spinners at every barrier
// (a 2.2 s build took 20 s beside two busy threads on 8 cores).
class Barrier {
  public:
    explicit Barrier(int n) : n_((uint32_t)n) {}
    void wait() {
        if (n_ == 1) return;
        const uint32_t g = gen_.load(std::memory_order_acquire);
        if (arrived_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
            arrived_.store(0, std::memory_order_relaxed);
            gen_.store(g + 1, std::memory_order_seq_cst);
            if (sleepers_.load(std::memory_order_seq_cst) > 0) wake_all();
            return;
        }
        const auto until = std::chrono::steady_clock::now() + SPIN;
        for (int i = 1;; i++) {
            if (gen_.load(std::memory_order_acquire) != g) return;
#if defined(__x86_64__) || defined(__i386__)
            __builtin_ia32_pause();
#endif
            if (i % 64 == 0 && std::chrono::steady_clock::now() > until) break;
        }
        sleepers_.fetch_add(1, std::memory_order_seq_cst);
        while (gen_.load(std::memory_order_seq_cst) == g) sleep_while(g);
        sleepers_.fetch_sub(1, std::memory_order_relaxed);
    }

  private:
    static constexpr std::chrono::microseconds SPIN{50};
    void sleep_while(uint32_t g) {
#ifdef __linux__
        syscall(SYS_futex, (uint32_t *)&gen_, FUTEX_WAIT_PRIVATE, g, nullptr,
                nullptr, 0);
#else
        (void)g;
        std::this_thread::yield();
#endif
    }
    void wake_all() {
#ifdef __linux__
        syscall(SYS_futex, (uint32_t *)&gen_, FUTEX_WAKE_PRIVATE, INT32_MAX,
                nullptr, nullptr, 0);
#endif
    }
    const uint32_t n_;
    std::atomic<uint32_t> arrived_{0}, gen_{0}, sleepers_{0};
};

// The threads of one parallel region: this one's index, their count and
// their barrier.  Each stage below runs on every thread of a team, which
// syncs only through the barrier, so a level of the sort opens a few
// parallel regions, not one a stage.
struct Team {
    int t, nt;
    Barrier *barrier;
    void sync() const { barrier->wait(); }
    void share(i64 lo, i64 hi, i64 *a, i64 *b) const {
        chunk(lo, hi, t, nt, a, b);
    }
};

// Runs body(team) on nt threads (all on one, where OpenMP gives fewer).
template <typename F>
static void in_team(int nt, F body) {
    Barrier barrier(nt), alone(1);
    if (nt == 1) {
        body(Team{0, 1, &alone});
        return;
    }
#pragma omp parallel num_threads(nt)
    {
        const int t = omp_get_thread_num();
#ifdef _OPENMP
        const bool whole = omp_get_num_threads() == nt;
#else
        const bool whole = false;
#endif
        if (whole)
            body(Team{t, nt, &barrier});
        else if (t == 0)
            body(Team{0, 1, &alone});
    }
}

template <typename C>
using UC = std::make_unsigned_t<C>;
template <typename C>
constexpr UC<C> S_BIT = (UC<C>)((UC<C>)1 << (8 * sizeof(C) - 1));
template <typename C>
inline bool s_type(C t) {
    return (UC<C>)t & S_BIT<C>;
}
template <typename C>
inline i64 sym(C t) {
    return (i64)((UC<C>)t & (UC<C>)(S_BIT<C> - 1));
}
// S after L; position 0 never is
template <typename C>
inline bool is_lms(const C *T, i64 i) {
    return i > 0 && s_type(T[i]) && !s_type(T[i - 1]);
}

template <typename IdxT>
struct Induced {
    IdxT sym;  // the induced suffix's first symbol (K: none), then its slot
    IdxT pos;  // the induced suffix
};

// What a level's stages share: the bucket sizes, per-thread counts by
// symbol (few symbols), per-thread totals, the induce passes' bucket
// pointers and, for many symbols, their block cache.
template <typename IdxT>
struct Scratch {
    std::vector<IdxT> cnt, ptr;
    std::vector<IdxT> part;    // [t * (K + 1) + symbol]
    std::vector<i64> total;    // [t + 1]
    i64 shared_at = 0;         // induce_waves: where thread 0 left the scan
    Buf<Induced<IdxT>> cache;  // induce_blocks: a block's entries
    Scratch(i64 n, i64 K, int nt)
        : cnt((size_t)K), ptr((size_t)K + 1), total((size_t)nt + 1) {
        if (K <= FEW_SYMBOLS) part.resize((size_t)nt * (K + 1));
        if (K > INDUCE_WAVES_K)
            cache.resize((size_t)std::min<i64>(n, INDUCE_BLOCK));
    }
};

// Folds each position's type into its symbol's top bit (set = S).  Each
// chunk takes its last position's type from the first place at or past
// it where the symbol changes, read before any chunk writes.
template <typename C>
static void classify(C *T, i64 n, const Team &tm) {
    i64 a, b;
    tm.share(0, n, &a, &b);
    bool s = true;
    for (i64 p = b - 1; a < b && p < n - 1; p++) {
        if (T[p] != T[p + 1]) {
            s = T[p] < T[p + 1];
            break;
        }
    }
    tm.sync();
    if (a < b) {
        if (s) T[b - 1] = (C)(T[b - 1] | S_BIT<C>);
        for (i64 i = b - 2; i >= a; i--) {
            const i64 x = sym(T[i]), y = sym(T[i + 1]);
            s = x < y || (x == y && s);
            if (s) T[i] = (C)(T[i] | S_BIT<C>);
        }
    }
    tm.sync();
}

// sc.cnt: the count of each symbol
template <typename C, typename IdxT>
static void bucket_counts(const C *T, i64 n, i64 K, const Team &tm,
                          Scratch<IdxT> &sc) {
    i64 a, b;
    if (K <= FEW_SYMBOLS) {
        // a histogram a thread, summed a range of symbols a thread
        IdxT *h = sc.part.data() + (size_t)tm.t * (K + 1);
        std::fill(h, h + K, 0);
        tm.share(0, n, &a, &b);
        for (i64 i = a; i < b; i++) h[sym(T[i])]++;
        tm.sync();
        tm.share(0, K, &a, &b);
        for (i64 c = a; c < b; c++) {
            IdxT sum = 0;
            for (int u = 0; u < tm.nt; u++)
                sum += sc.part[(size_t)u * (K + 1) + c];
            sc.cnt[c] = sum;
        }
    } else {
        // many symbols (a recursion's names): collisions are rare
        tm.share(0, K, &a, &b);
        std::fill(sc.cnt.data() + a, sc.cnt.data() + b, 0);
        tm.sync();
        tm.share(0, n, &a, &b);
        for (i64 i = a; i < b; i++)
            __atomic_fetch_add(&sc.cnt[sym(T[i])], 1, __ATOMIC_RELAXED);
    }
    tm.sync();
}

template <typename IdxT>
static void bucket_starts(const std::vector<IdxT> &cnt, IdxT *out) {
    IdxT sum = 0;
    for (size_t c = 0; c < cnt.size(); c++) {
        out[c] = sum;
        sum += cnt[c];
    }
}

template <typename IdxT>
static void bucket_ends(const std::vector<IdxT> &cnt, IdxT *out) {
    IdxT sum = 0;
    for (size_t c = 0; c < cnt.size(); c++) {
        sum += cnt[c];
        out[c] = sum;
    }
}

// this thread's share of p[lo, hi) = v
template <typename T>
inline void fill(T *p, i64 lo, i64 hi, T v, const Team &tm) {
    i64 a, b;
    tm.share(lo, hi, &a, &b);
    std::fill(p + a, p + b, v);
}

// Keeps the entries of SA[lo, hi) that satisfy `keep`, in order, packed
// to the left end (right = false) or the right end of the range; returns
// their count.  Each chunk packs itself in place, then one thread moves
// the packed runs, in the order that never overwrites one not yet moved.
template <typename IdxT, typename Keep>
static i64 compact(IdxT *SA, i64 lo, i64 hi, bool right, const Team &tm,
                   std::vector<i64> &kept, Keep keep) {
    i64 a, b;
    tm.share(lo, hi, &a, &b);
    if (!right) {
        i64 w = a;
        for (i64 i = a; i < b; i++)
            if (keep(SA[i])) SA[w++] = SA[i];
        kept[tm.t] = w - a;
    } else {
        i64 w = b;
        for (i64 i = b - 1; i >= a; i--)
            if (keep(SA[i])) SA[--w] = SA[i];
        kept[tm.t] = b - w;
    }
    tm.sync();
    i64 total = 0;
    for (int u = 0; u < tm.nt; u++) total += kept[u];
    if (tm.t == 0) {
        i64 moved = 0;
        for (int k = 0; k < tm.nt; k++) {
            const int u = right ? tm.nt - 1 - k : k;
            chunk(lo, hi, u, tm.nt, &a, &b);
            moved += kept[u];
            const i64 from = right ? b - kept[u] : a;
            const i64 to = right ? hi - moved : lo + moved - kept[u];
            if (from != to)
                std::memmove(SA + to, SA + from, sizeof(IdxT) * kept[u]);
        }
    }
    tm.sync();
    return total;
}

// Places the LMS positions of T at the ends of their buckets in SA
// (which holds EMPTY).  The order inside a bucket does not matter to the
// LMS-substring sort.  Few symbols: each chunk counts its positions by
// bucket and fills its slots below those of the chunks to its right (the
// serial scan's order); many: each position takes a slot by an atomic
// decrement, collisions being rare.
template <typename C, typename IdxT>
static void place_lms(const C *T, i64 n, IdxT *SA, const Team &tm,
                      Scratch<IdxT> &sc) {
    const i64 K = (i64)sc.cnt.size();
    i64 a, b;
    tm.share(1, n, &a, &b);
    if (K > FEW_SYMBOLS) {
        if (tm.t == 0) bucket_ends(sc.cnt, sc.ptr.data());
        tm.sync();
        IdxT *bp = sc.ptr.data();
        for (i64 i = a; i < b; i++)
            if (is_lms(T, i))
                SA[__atomic_sub_fetch(&bp[sym(T[i])], 1, __ATOMIC_RELAXED)] =
                    (IdxT)i;
        tm.sync();
        return;
    }
    IdxT *h = sc.part.data() + (size_t)tm.t * (K + 1);
    std::fill(h, h + K, 0);
    for (i64 i = a; i < b; i++)
        if (is_lms(T, i)) h[sym(T[i])]++;
    tm.sync();
    if (tm.t == 0) {
        bucket_ends(sc.cnt, sc.ptr.data());
        for (int u = tm.nt - 1; u >= 0; u--)
            for (i64 c = 0; c < K; c++) {
                IdxT &k = sc.part[(size_t)u * (K + 1) + c];
                sc.ptr[c] -= k;
                k = sc.ptr[c];
            }
    }
    tm.sync();
    for (i64 i = a; i < b; i++)
        if (is_lms(T, i)) SA[h[sym(T[i])]++] = (IdxT)i;
    tm.sync();
}

// What SA entry j induces in a pass over `want_s` types: suffix j-1 when
// its type is the pass's, else nothing (symbol K).
template <typename C, typename IdxT>
inline Induced<IdxT> induced_by(const C *T, IdxT j, bool want_s, IdxT K) {
    if (j > 0) {
        const C t = T[j - 1];
        if (s_type(t) == want_s) return {(IdxT)sym(t), (IdxT)(j - 1)};
    }
    return {K, 0};
}

constexpr i64 PF = 32;  // prefetch distance of the induce passes, entries

// Few symbols (the text's bytes): bucket by bucket, in the serial scan's
// order.  The L pass reads bucket c's L-part while it still grows, so it
// goes in waves: the entries written there so far, [i, bp[c]), induce
// their suffixes together, and those that land in bucket c make the next
// wave; once a wave adds none, the rest of the bucket, which the pass
// does not write, is one range.  The S pass mirrors it from the right.
// A long range the threads split: each counts what its share induces by
// symbol, the counts give each thread its slots of every bucket in the
// serial scan's order, and each places its own.  Short ones, as the last
// waves of a bucket are, one thread scans on through until a long one
// comes.  A pass takes two barriers a long range, a few hundred in all
// for a text of millions, against thousands for blocks of the SA.
template <typename C, typename IdxT>
static void induce_waves(const C *T, i64 n, IdxT *SA, const Team &tm,
                         Scratch<IdxT> &sc, bool s_pass) {
    const i64 K = (i64)sc.cnt.size();
    const int t = tm.t, nt = tm.nt;
    const bool fwd = !s_pass;
    const i64 long_range =
        nt == 1 ? n + 1 : std::max<i64>(1 << 14, (i64)nt * 4096);
    // each bucket's [start, end), and this thread's copy of the bucket
    // pointers, one more for the entries inducing nothing
    std::vector<IdxT> lo_of((size_t)K), hi_of((size_t)K), bp((size_t)K + 1);
    std::vector<IdxT> slot((size_t)K + 1);
    bucket_starts(sc.cnt, lo_of.data());
    bucket_ends(sc.cnt, hi_of.data());
    std::copy(s_pass ? hi_of.begin() : lo_of.begin(),
              s_pass ? hi_of.end() : lo_of.end(), bp.begin());
    IdxT *h = sc.part.data() + (size_t)t * (K + 1);
    // the next entry to scan (L: the lowest left, S: past the highest)
    i64 at = s_pass ? n : 0;
    i64 c = s_pass ? K - 1 : 0;  // the bucket that holds it
    // the range the scan may take from `at` at once, [a, b)
    auto next = [&](i64 *a, i64 *b) {
        if (fwd) {
            while (at >= (i64)hi_of[c]) c++;
            *a = at;
            *b = at < (i64)bp[c] ? (i64)bp[c] : (i64)hi_of[c];
        } else {
            while (at <= (i64)lo_of[c]) c--;
            *b = at;
            *a = at > (i64)bp[c] ? (i64)bp[c] : (i64)lo_of[c];
        }
    };
    while (fwd ? at < n : at > 0) {
        i64 a, b;
        next(&a, &b);
        if (b - a < long_range) {
            // short: thread 0 scans on alone to the next long range
            if (t == 0) {
                for (bool first = true; fwd ? at < n : at > 0; first = false) {
                    next(&a, &b);
                    if (!first && b - a >= long_range) break;
                    if (fwd) {
                        for (i64 i = a; i < b; i++) {
                            const Induced<IdxT> x =
                                induced_by(T, SA[i], false, (IdxT)K);
                            if (x.sym != K) SA[bp[x.sym]++] = x.pos;
                        }
                    } else {
                        for (i64 i = b - 1; i >= a; i--) {
                            const Induced<IdxT> x =
                                induced_by(T, SA[i], true, (IdxT)K);
                            if (x.sym != K) SA[--bp[x.sym]] = x.pos;
                        }
                    }
                    at = fwd ? b : a;
                }
                std::copy(bp.begin(), bp.end(), sc.ptr.begin());
                sc.shared_at = at;
            }
            // (thread 0 writes them again only past a barrier that the
            // others reach after reading them)
            tm.sync();
            if (t != 0) {
                std::copy(sc.ptr.begin(), sc.ptr.end(), bp.begin());
                at = sc.shared_at;
            }
            continue;
        }
        // long: count this thread's share by symbol (K: nothing) ...
        i64 s0, s1;
        tm.share(a, b, &s0, &s1);
        std::fill(h, h + K + 1, 0);
        for (i64 i = s0; i < s1; i++) {
            if (i + PF < s1) {
                const IdxT jp = SA[i + PF];
                __builtin_prefetch(T + (jp > 0 ? jp - 1 : 0));
            }
            h[induced_by(T, SA[i], s_pass, (IdxT)K).sym]++;
        }
        tm.sync();
        // ... take its slots: the shares before it in scan order (L: to
        // its left, S: to its right) fill theirs first ...
        for (i64 s = 0; s < K; s++) {
            IdxT before = 0, total = 0;
            for (int u = 0; u < nt; u++) {
                const IdxT k = sc.part[(size_t)u * (K + 1) + s];
                before += (fwd ? u < t : u > t) ? k : 0;
                total += k;
            }
            slot[s] = fwd ? bp[s] + before : bp[s] - before;
            bp[s] = fwd ? bp[s] + total : bp[s] - total;
        }
        // ... and place its entries, none of them inside [a, b)
        if (fwd) {
            for (i64 i = s0; i < s1; i++) {
                const Induced<IdxT> x = induced_by(T, SA[i], false, (IdxT)K);
                if (x.sym != K) SA[slot[x.sym]++] = x.pos;
            }
        } else {
            for (i64 i = s1 - 1; i >= s0; i--) {
                const Induced<IdxT> x = induced_by(T, SA[i], true, (IdxT)K);
                if (x.sym != K) SA[--slot[x.sym]] = x.pos;
            }
        }
        at = fwd ? b : a;
        tm.sync();
    }
    tm.sync();
}

// Many symbols (a recursion's names): blocks of the SA.  The threads
// gather what each entry of a block induces; one thread places the
// entries through the bucket pointers in scan order (an entry placed
// inside the block is gathered there and then, as the serial scan would
// read it); the threads scatter them.  Three barriers a block.
template <typename C, typename IdxT>
static void induce_blocks(const C *T, i64 n, IdxT *SA, const Team &tm,
                          Scratch<IdxT> &sc, bool s_pass) {
    const IdxT K = (IdxT)sc.cnt.size();
    IdxT *bp = sc.ptr.data();  // bucket pointers, one more nothing moves
    if (tm.t == 0) {
        if (s_pass)
            bucket_ends(sc.cnt, bp);
        else
            bucket_starts(sc.cnt, bp);
    }
    const i64 B = (i64)sc.cache.size();
    Induced<IdxT> *c = sc.cache.data();
    for (i64 blk = 0; blk < n; blk += B) {
        const i64 b = s_pass ? std::max<i64>(0, n - blk - B) : blk;
        const i64 e = s_pass ? n - blk : std::min(n, blk + B);
        i64 g0, g1;
        // gather
        tm.share(b, e, &g0, &g1);
        for (i64 i = g0; i < g1; i++) {
            if (i + PF < g1) {
                const IdxT jp = SA[i + PF];
                __builtin_prefetch(T + (jp > 0 ? jp - 1 : 0));
            }
            c[i - b] = induced_by(T, SA[i], s_pass, K);
        }
        tm.sync();
        // place, in the serial scan's order; slot -1: nothing induced
        // (branch-free: half the entries induce nothing, at random)
        if (tm.t == 0 && !s_pass) {
            for (i64 k = 0; k < e - b; k++) {
                if (k + PF < e - b) __builtin_prefetch(bp + c[k + PF].sym);
                const IdxT s = c[k].sym;
                const IdxT d = bp[s]++;
                c[k].sym = d | -(IdxT)(s == K);
                if ((d > b + k) & (d < e) & (s != K))
                    c[d - b] = induced_by(T, c[k].pos, false, K);
            }
        } else if (tm.t == 0) {
            for (i64 k = e - b - 1; k >= 0; k--) {
                if (k >= PF) __builtin_prefetch(bp + c[k - PF].sym);
                const IdxT s = c[k].sym;
                const IdxT d = --bp[s];
                c[k].sym = d | -(IdxT)(s == K);
                if ((d >= b) & (d < b + k) & (s != K))
                    c[d - b] = induced_by(T, c[k].pos, true, K);
            }
        }
        tm.sync();
        // scatter
        tm.share(0, e - b, &g0, &g1);
        for (i64 k = g0; k < g1; k++)
            if (c[k].sym >= 0) SA[c[k].sym] = c[k].pos;
        tm.sync();
    }
}

// The two induce passes: L left to right from the bucket heads, then S
// right to left from the bucket ends.
template <typename C, typename IdxT>
static void induce(const C *T, i64 n, IdxT *SA, const Team &tm,
                   Scratch<IdxT> &sc) {
    for (const bool s_pass : {false, true}) {
        if ((i64)sc.cnt.size() <= INDUCE_WAVES_K)
            induce_waves(T, n, SA, tm, sc, s_pass);
        else
            induce_blocks(T, n, SA, tm, sc, s_pass);
    }
}

// Does the LMS substring at a differ from the one at b?  Folded symbols
// carry their types, so equal symbols have equal types too.
template <typename C>
inline bool lms_differ(const C *T, i64 a, i64 b) {
    for (i64 d = 0;; d++) {
        if (T[a + d] != T[b + d]) return true;
        if (d > 0 && is_lms(T, a + d)) return false;
    }
}

// SA[0, n1) holds the LMS positions sorted by LMS substring.  Writes
// each one's name (0-based, equal substrings alike, in that order) to
// SA[n1 + pos / 2] and EMPTY to the rest of SA[n1, n); returns the count
// of names.  A name starts where a substring differs from the one before
// it: marked in the entry's top bit, counted a chunk, then summed.
template <typename C, typename IdxT>
static i64 name_lms(const C *T, i64 n, IdxT *SA, i64 n1, const Team &tm,
                    std::vector<i64> &starts) {
    const IdxT EMPTY = (IdxT)-1;
    const IdxT MARK = std::numeric_limits<IdxT>::min();
    i64 a, b;
    tm.share(0, n1, &a, &b);
    i64 prev = a > 0 ? (i64)SA[a - 1] : -1;
    fill(SA, n1, n, EMPTY, tm);
    tm.sync();
    i64 count = 0;
    for (i64 k = a; k < b; k++) {
        const i64 pos = SA[k];
        if (prev < 0 || lms_differ(T, prev, pos)) {
            SA[k] = (IdxT)(pos | MARK);
            count++;
        }
        prev = pos;
    }
    starts[tm.t + 1] = count;
    tm.sync();
    i64 name = -1, names = 0;
    for (int u = 0; u <= tm.nt; u++) {
        if (u == tm.t) name = names - 1;
        if (u < tm.nt) names += starts[u + 1];
    }
    for (i64 k = a; k < b; k++) {
        IdxT v = SA[k];
        if (v < 0) {
            v = (IdxT)(v & ~MARK);
            name++;
            SA[k] = v;
        }
        SA[n1 + v / 2] = (IdxT)name;
    }
    tm.sync();
    return names;
}

// Writes the LMS positions of T in text order to out[0, n1).
template <typename C, typename IdxT>
static void lms_in_text_order(const C *T, i64 n, IdxT *out, const Team &tm,
                              std::vector<i64> &starts) {
    i64 a, b;
    tm.share(1, n, &a, &b);
    i64 count = 0;
    for (i64 i = a; i < b; i++) count += is_lms(T, i);
    starts[tm.t + 1] = count;
    tm.sync();
    i64 w = 0;
    for (int u = 0; u < tm.t; u++) w += starts[u + 1];
    for (i64 i = a; i < b; i++)
        if (is_lms(T, i)) out[w++] = (IdxT)i;
    tm.sync();
}

// Moves the sorted LMS positions in SA[0, n1) to the ends of their
// buckets, in order, and empties the rest of SA.  The threads read each
// one's symbol first, so the one thread that moves them reads in sequence.
template <typename C, typename IdxT>
static void place_sorted_lms(const C *T, i64 n, i64 n1, IdxT *SA,
                             IdxT *syms, const Team &tm, Scratch<IdxT> &sc) {
    const IdxT EMPTY = (IdxT)-1;
    i64 a, b;
    tm.share(0, n1, &a, &b);
    for (i64 k = a; k < b; k++) syms[k] = (IdxT)sym(T[SA[k]]);
    fill(SA, n1, n, EMPTY, tm);
    tm.sync();
    if (tm.t == 0) {
        IdxT *ptr = sc.ptr.data();
        bucket_ends(sc.cnt, ptr);
        for (i64 k = n1 - 1; k >= 0; k--) {
            const IdxT pos = SA[k];
            SA[k] = EMPTY;
            SA[--ptr[syms[k]]] = pos;
        }
    }
    tm.sync();
}

// Sorts the suffixes of T[0, n) into SA[0, n).  T[n-1] must be the
// unique smallest symbol (0); symbols are below K and leave the top bit
// free, which this level takes for the types.  Two parallel regions a
// level, one either side of the recursion.
template <typename C, typename IdxT>
static void sais_rec(C *T, i64 n, i64 K, IdxT *SA, SaisCtx &ctx) {
    const IdxT EMPTY = (IdxT)-1;
    if (n == 1) {
        SA[0] = 0;
        return;
    }
    ctx.depth++;
    ctx.levels = std::max(ctx.levels, ctx.depth);
    const int nt = ctx.threads_for(n);
    Scratch<IdxT> sc(n, K, nt);
    i64 n1 = 0, names = 0;
    in_team(nt, [&](const Team &tm) {
        classify(T, n, tm);
        bucket_counts(T, n, K, tm, sc);
        // ---- step 1: sort LMS substrings by induction ----
        fill(SA, 0, n, EMPTY, tm);
        tm.sync();
        place_lms(T, n, SA, tm, sc);
        induce(T, n, SA, tm, sc);
        // the sorted LMS positions to SA[0, n1); the sentinel n-1 is one
        // (T[n-2] > T[n-1] makes it an S after an L) and comes first
        const i64 m = compact(SA, 0, n, false, tm, sc.total, [T](IdxT j) {
            return j > 0 && is_lms(T, (i64)j);
        });
        // ---- step 2: name LMS substrings ----
        const i64 k = name_lms(T, n, SA, m, tm, sc.total);
        // the reduced string (names in text order) to SA[n - n1, n)
        compact(SA, m, n, true, tm, sc.total,
                [EMPTY](IdxT v) { return v != EMPTY; });
        if (tm.t == 0) n1 = m, names = k;
    });
    IdxT *reduced = SA + n - n1;
    if (names < n1) sais_rec(reduced, n1, names, SA, ctx);

    Buf<IdxT> syms((size_t)n1);
    in_team(nt, [&](const Team &tm) {
        i64 a, b;
        tm.share(0, n1, &a, &b);
        if (names == n1)
            for (i64 k = a; k < b; k++) SA[reduced[k]] = (IdxT)k;
        // SA[0, n1): the LMS positions, sorted
        lms_in_text_order(T, n, reduced, tm, sc.total);
        for (i64 k = a; k < b; k++) SA[k] = reduced[SA[k]];
        tm.sync();
        // ---- step 3: induce the final SA from the sorted LMS positions ----
        place_sorted_lms(T, n, n1, SA, syms.data(), tm, sc);
        induce(T, n, SA, tm, sc);
    });
    ctx.depth--;
}

// The SA of s[0, n) behind its sentinel suffix: n + 1 entries, [0] = n.
// Genomic alphabets hold no NUL and no byte above 0x7F, so a copy of the
// bytes with 0 appended is the level-0 text; any other text is widened
// to int32 symbols s + 1.
template <typename IdxT>
static Buf<IdxT> sais_text(const u8 *s, i64 n, SaisCtx &ctx) {
    ctx.threads = n + 1 >= PAR_MIN_N ? omp_get_max_threads() : 1;
    std::vector<u8> wide_of((size_t)ctx.threads, 0);
    in_team(ctx.threads, [&](const Team &tm) {
        i64 a, b;
        tm.share(0, n, &a, &b);
        u8 w = 0;
        for (i64 i = a; i < b; i++) w |= (s[i] == 0) | (s[i] >= 0x80);
        wide_of[tm.t] = w;
    });
    const bool wide = std::count(wide_of.begin(), wide_of.end(), 1) > 0;
    Buf<IdxT> SA((size_t)n + 1);
    auto copy = [&](auto *T, i64 add) {
        in_team(ctx.threads, [&](const Team &tm) {
            i64 a, b;
            tm.share(0, n, &a, &b);
            for (i64 i = a; i < b; i++) T[i] = s[i] + add;
        });
        T[n] = 0;
    };
    if (!wide) {
        Buf<u8> T((size_t)n + 1);
        copy(T.data(), 0);
        sais_rec(T.data(), n + 1, 128, SA.data(), ctx);
    } else {
        Buf<int32_t> T((size_t)n + 1);
        copy(T.data(), 1);
        sais_rec(T.data(), n + 1, 257, SA.data(), ctx);
    }
    return SA;
}

}  // namespace

// Build SA over a byte string (no sentinel required from the caller).
static std::vector<i64> build_sa_bytes(const u8 *s, i64 n) {
    if (n == 0) return {};
    SaisCtx ctx;
    std::vector<i64> out((size_t)n);
    auto drop_sentinel = [&](const auto &sa) {
        in_team(ctx.threads, [&](const Team &tm) {
            i64 a, b;
            tm.share(0, n, &a, &b);
            for (i64 i = a; i < b; i++) out[i] = (i64)sa[i + 1];
        });
    };
    if (n + 1 < (i64)INT32_MAX)
        drop_sentinel(sais_text<int32_t>(s, n, ctx));
    else
        drop_sentinel(sais_text<i64>(s, n, ctx));
    return out;
}

// ---------------------------------------------------------------------------
// Longest-prefix-match index: SA + k-mer bucket acceleration.
//
// Spec (matches the reference's get_match_cached result, see
// phylonium_tpu/index/esa_numpy.py): longest_match(q) = (l, i, j) with l
// the longest prefix of q occurring in S and [i, j] the inclusive SA range
// of suffixes carrying that prefix.
// ---------------------------------------------------------------------------

namespace {

struct Index {
    std::vector<u8> S;
    Buf<i64> SA;
    i64 n = 0;  // |S|

    // int32 SA for the probe path: halves the random-access footprint of
    // the search (the probes are memory-latency bound).  SA-IS sorts into
    // it whenever n fits; texts beyond 2^31 fall back to the i64 SA.
    Buf<int32_t> SA32;

    // how the build went: its OpenMP threads, the SA-IS levels that ran,
    // and the seconds of the suffix sort and of the bucket tables
    int build_threads = 1;
    int sais_levels = 0;
    double sais_s = 0.0, buckets_s = 0.0;
    i64 suf(i64 idx) const {
        return SA32.empty() ? SA[idx] : (i64)SA32[idx];
    }

    // Two-level k-mer bucket tables: for each ACGT-only k-mer code,
    // the SA range of suffixes starting with it (int32 [lo, hi) pairs,
    // lo = -1 for an absent k-mer).  The primary width scales with the
    // text so present buckets average ~2-3 suffixes (the probe
    // pipeline's per-probe scan is compute-bound on the bucket's lcp
    // wave — at 10 Mbp texts the fixed k=10 table averaged ~10
    // members); an EMPTY primary bucket proves the match is shorter
    // than `kmer`, and the k=10 secondary (present only when
    // kmer > 10) catches those probes instead of the full-range binary
    // search.  Parity at every level: a non-empty width-w bucket
    // contains ALL suffixes sharing q's w-byte prefix, and the max-lcp
    // attainers share >= max >= w of them, so (len, pos, unique)
    // computed inside the bucket is exact.
    int kmer = 10;   // primary width
    int kmer0 = 0;   // secondary width (0 = no secondary table)
    Buf<int32_t> bucket_lo;   // primary: [2c] = lo, [2c+1] = hi
    Buf<int32_t> bucket0_lo;  // secondary, same layout
    bool has_buckets = false;

    // leading ACGT-only bases of p packed 2-bit big-endian into *code;
    // returns their count, capped at `kmer`
    int lead_code(const u8 *p, i64 avail, i64 *code) const {
#if defined(__SSSE3__) && defined(__BMI2__)
        // fast path: one 16-byte load covers any kmer <= 13.  Needs 16
        // readable bytes, so gate on avail (query buffers carry no
        // slack past their last byte).
        if (avail >= 16 && kmer >= 8 && kmer <= 13) {
            const __m128i v = _mm_loadu_si128((const __m128i *)p);
            const __m128i okA = _mm_cmpeq_epi8(v, _mm_set1_epi8('A'));
            const __m128i okC = _mm_cmpeq_epi8(v, _mm_set1_epi8('C'));
            const __m128i okG = _mm_cmpeq_epi8(v, _mm_set1_epi8('G'));
            const __m128i okT = _mm_cmpeq_epi8(v, _mm_set1_epi8('T'));
            const __m128i ok =
                _mm_or_si128(_mm_or_si128(okA, okC), _mm_or_si128(okG, okT));
            const uint32_t bad = ~(uint32_t)_mm_movemask_epi8(ok) & 0xFFFFu;
            if (!bad || __builtin_ctz(bad) >= kmer) {
                // all kmer leading bytes are ACGT: vector-encode.
                // Low nibbles are distinct (A=1, C=3, G=7, T=4), and
                // '!'/'#' bytes can't reach here (the bad gate holds).
                const __m128i lut = _mm_setr_epi8(0, 0, 0, 1, 3, 0, 0, 2,
                                                  0, 0, 0, 0, 0, 0, 0, 0);
                const __m128i codes = _mm_shuffle_epi8(
                    lut, _mm_and_si128(v, _mm_set1_epi8(0x0F)));
                const uint64_t mask2 = 0x0303030303030303ull;
                uint64_t b0, b1;
                std::memcpy(&b0, &codes, 8);
                std::memcpy(&b1, (const char *)&codes + 8, 8);
                // bswap+pext: byte k's 2 bits land big-endian (base 0
                // most significant of the 16-bit group)
                const uint64_t c0 = _pext_u64(__builtin_bswap64(b0), mask2);
                const uint64_t c1 = _pext_u64(__builtin_bswap64(b1), mask2);
                *code = (i64)((c0 << (2 * (kmer - 8))) |
                              (c1 >> (2 * (16 - kmer))));
                return kmer;
            }
        }
#endif
        const int cap = (int)std::min<i64>(kmer, avail);
        i64 v = 0;
        int t = 0;
        for (; t < cap; t++) {
            i64 c;
            switch (p[t]) {
                case 'A': c = 0; break;
                case 'C': c = 1; break;
                case 'G': c = 2; break;
                case 'T': c = 3; break;
                default: { *code = v; return t; }
            }
            v = (v << 2) | c;
        }
        *code = v;
        return t;
    }

    i64 code_of(const u8 *p, i64 avail) const {
        i64 code;
        return lead_code(p, avail, &code) == kmer ? code : -1;
    }

    // lcp of S[sp:] with q[qs:], capped
    i64 lcp(i64 sp, const u8 *q, i64 qlen, i64 cap) const {
        i64 m = std::min(cap, std::min(n - sp, qlen));
        const u8 *a = S.data() + sp;
        i64 t = 0;
#if defined(__AVX2__)
        // 32-byte strides: most calls either mismatch inside the first
        // vector (one compare replaces 2-4 scalar rounds) or run long
        // (4x the scalar stride).  m bounds both buffers, no overread.
        for (; t + 32 <= m; t += 32) {
            const __m256i x = _mm256_loadu_si256((const __m256i *)(a + t));
            const __m256i y = _mm256_loadu_si256((const __m256i *)(q + t));
            const uint32_t eq =
                (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, y));
            if (eq != 0xFFFFFFFFu) return t + (i64)__builtin_ctz(~eq);
        }
#endif
        for (; t + 8 <= m; t += 8) {
            uint64_t x, y;
            std::memcpy(&x, a + t, 8);
            std::memcpy(&y, q + t, 8);
            if (x != y) {
                uint64_t diff = x ^ y;
                return t + (i64)(__builtin_ctzll(diff) >> 3);
            }
        }
        for (; t < m; t++) {
            if (a[t] != q[t]) return t;
        }
        return m;
    }

    // lcp of S[sp:] with q[qs:], starting from a known-equal prefix of
    // `skip` bytes (bucket membership guarantees the first KMER bytes)
    i64 lcp_from(i64 sp, const u8 *q, i64 qlen, i64 cap, i64 skip) const {
        i64 m = std::min(cap, std::min(n - sp, qlen));
        if (skip >= m) return m;
        return skip + lcp(sp + skip, q + skip, qlen - skip, m - skip);
    }

    // compare suffix SA[idx] against prefix q[0:plen]:
    // <0 suffix smaller, 0 suffix starts with prefix, >0 suffix bigger
    int cmp_prefix(i64 idx, const u8 *q, i64 plen, i64 skip = 0) const {
        i64 p = suf(idx);
        i64 l = lcp_from(p, q, plen, plen, skip);
        if (l == plen) return 0;
        if (p + l >= n) return -1;  // suffix exhausted -> smaller
        return (int)S[p + l] - (int)q[l];
    }

    i64 lower_bound(const u8 *q, i64 plen, i64 lo, i64 hi,
                    i64 skip = 0) const {
        while (lo < hi) {
            i64 mid = lo + (hi - lo) / 2;
            if (cmp_prefix(mid, q, plen, skip) < 0)
                lo = mid + 1;
            else
                hi = mid;
        }
        return lo;
    }

    i64 upper_bound(const u8 *q, i64 plen, i64 lo, i64 hi) const {
        while (lo < hi) {
            i64 mid = lo + (hi - lo) / 2;
            if (cmp_prefix(mid, q, plen) <= 0)
                lo = mid + 1;
            else
                hi = mid;
        }
        return lo;
    }

    // SA32 (or SA past 2^31) by SA-IS, without its sentinel suffix
    void build_sa() {
        SaisCtx ctx;
        if (n == 0) return;
        // move each entry one slot left, each chunk reading the entry
        // past its end before any chunk writes
        auto drop_sentinel = [&](auto &sa) {
            in_team(ctx.threads, [&](const Team &tm) {
                i64 a, b;
                tm.share(0, n, &a, &b);
                const auto past = sa[b];
                tm.sync();
                if (a < b) {
                    std::memmove(sa.data() + a, sa.data() + a + 1,
                                 sizeof(sa[0]) * (b - 1 - a));
                    sa[b - 1] = past;
                }
            });
            sa.resize(n);
        };
        if (n + 1 < (i64)INT32_MAX) {
            SA32 = sais_text<int32_t>(S.data(), n, ctx);
            drop_sentinel(SA32);
        } else {
            SA = sais_text<i64>(S.data(), n, ctx);
            drop_sentinel(SA);
        }
        build_threads = ctx.threads;
        sais_levels = ctx.levels;
    }

    void build_buckets(int nt) {
        if (n >= (i64)INT32_MAX) return;  // probe path falls back to i64

        // smallest width with expected occupancy <= ~2.5, clamped to
        // [8, 13] (k=13 = 512 MB table, reached beyond ~168 Mbp texts)
        int k = 8;
        while (k < 13 && ((i64)1 << (2 * k)) * 5 / 2 < n) k++;
        if (const char *e = std::getenv("PHYLONIUM_TPU_KMER")) {
            int v = std::atoi(e);
            if (v >= 2 && v <= 15) k = v;
        }
        kmer = k;

        // secondary table one base narrower (capped at 10): probes whose
        // match is shorter than the primary width — or whose primary
        // bucket is absent — resolve against the far-denser secondary
        // range instead of a full-SA binary search.  Without it, small
        // texts (kmer <= 10) sent every absent-primary probe through
        // ~21 full-range bisection steps (~40% of tier-3 map cycles).
        kmer0 = (kmer > 4) ? std::min(kmer - 1, 10) : 0;

        // Per-position code precompute in TEXT order (a backward rolling
        // pass a chunk, sequential), so the SA walk below reads one
        // prefetchable u32 per entry instead of ~k random text bytes:
        // packed[p] = (min(valid_run, 15) << 28) | code(p .. p+kmer-1)
        // (code bits covering invalid bytes are garbage, but the run
        // gate means they are only read when the covered prefix is
        // fully valid).  2*kmer <= 26 bits, run uses 4.  A chunk starts
        // rolling 15 bytes past its end: the state there (a run capped
        // at 15, a code of at most 15 bases) no longer depends on what
        // lies further.
        Buf<uint32_t> packed((size_t)n);
        const i64 nb = (i64)1 << (2 * kmer);
        const i64 nb0 = kmer0 ? (i64)1 << (2 * kmer0) : 0;
        bucket_lo.resize(2 * nb);
        bucket0_lo.resize(2 * nb0);
        SA.resize(n);
        struct Run {
            i64 code = -1;
            int32_t lo = 0, hi = 0;
        };
        // [t][0/1]: chunk t's first and last run of the primary, [2/3]
        // of the secondary
        std::vector<std::array<Run, 4>> edges(nt);
        const uint32_t krun = (uint32_t)kmer, krun0 = (uint32_t)kmer0;
        const int shift0 = 2 * (kmer - kmer0);
        in_team(nt, [&](const Team &tm) {
            i64 a, b;
            tm.share(0, n, &a, &b);
            uint32_t code = 0;
            uint32_t run = 0;
            for (i64 p = std::min(n, b + 15) - 1; p >= a; p--) {
                uint32_t c;
                switch (S[(size_t)p]) {
                    case 'A': c = 0; break;
                    case 'C': c = 1; break;
                    case 'G': c = 2; break;
                    case 'T': c = 3; break;
                    default: c = 4; break;
                }
                if (c > 3) {
                    run = 0;
                    code >>= 2;
                } else {
                    if (run < 15) run++;
                    code = (c << (2 * (kmer - 1))) | (code >> 2);
                }
                if (p < b) packed[(size_t)p] = (run << 28) | code;
            }
            fill(bucket_lo.data(), 0, 2 * nb, (int32_t)-1, tm);
            fill(bucket0_lo.data(), 0, 2 * nb0, (int32_t)-1, tm);
            tm.sync();

            // walk the SA once: valid ACGT k-mer codes appear in
            // non-decreasing order along the SA (suffixes sharing a
            // k-prefix are contiguous); record each code's [first, last]
            // SA range at both widths.  A chunk of the SA writes the codes
            // strictly inside its range of codes, which no other chunk
            // holds; its first and last code may run on into its
            // neighbours, so they merge after, by min and max.
            std::array<Run, 4> &edge = edges[tm.t];
            Run cur, cur0;
            // a finished run: the chunk's first goes to its edges, any
            // later one straight into the table
            auto close = [&](Run &r, int first, Buf<int32_t> &tab) {
                if (r.code < 0) return;
                if (edge[first].code < 0) {
                    edge[first] = r;
                } else {
                    tab[2 * r.code] = r.lo;
                    tab[2 * r.code + 1] = r.hi;
                }
            };
            auto extend = [&](Run &r, i64 code, i64 i, int first,
                              Buf<int32_t> &tab) {
                if (code == r.code) {
                    r.hi = (int32_t)(i + 1);
                } else {
                    close(r, first, tab);
                    r = {code, (int32_t)i, (int32_t)(i + 1)};
                }
            };
            for (i64 i = a; i < b; i++) {
                if (i + 16 < b)
                    __builtin_prefetch(packed.data() + SA32[(size_t)(i + 16)]);
                const uint32_t pk = packed[(size_t)SA32[(size_t)i]];
                const uint32_t run = pk >> 28;
                const i64 code = (i64)(pk & ((1u << 28) - 1));
                if (run >= krun) extend(cur, code, i, 0, bucket_lo);
                if (kmer0 && run >= krun0)
                    extend(cur0, code >> shift0, i, 2, bucket0_lo);
                // the i64 SA that phy_index_sa hands out
                SA[(size_t)i] = SA32[(size_t)i];
            }
            // the last run is an edge too (the first, if it is the only one)
            if (edge[0].code < 0) edge[0] = cur; else edge[1] = cur;
            if (edge[2].code < 0) edge[2] = cur0; else edge[3] = cur0;
        });
        for (const auto &edge : edges)
            for (int j = 0; j < 4; j++) {
                const Run &r = edge[j];
                if (r.code < 0) continue;
                int32_t *slot =
                    (j < 2 ? bucket_lo : bucket0_lo).data() + 2 * r.code;
                if (slot[0] < 0 || r.lo < slot[0]) slot[0] = r.lo;
                slot[1] = std::max(slot[1], r.hi);
            }
        has_buckets = true;
    }

    // Narrowed SA range for q's prefix via the bucket tables; returns
    // the bucket width used as the search's known-equal skip (0 = full
    // range).  An empty primary proves the longest match < kmer, so
    // the secondary's [lo, hi) still contains every max-lcp attainer.
    int bucket_range(const u8 *q, i64 avail, i64 *lo, i64 *hi) const {
        *lo = 0;
        *hi = n;
        if (!has_buckets) return 0;
        i64 code;
        int v = lead_code(q, avail, &code);
        if (v == kmer) {
            i64 blo = bucket_lo[2 * code];
            if (blo >= 0) {
                *lo = blo;
                *hi = bucket_lo[2 * code + 1];
                return kmer;
            }
        }
        if (kmer0 && v >= kmer0) {
            i64 c0 = code >> (2 * (v - kmer0));
            i64 blo = bucket0_lo[2 * c0];
            if (blo >= 0) {
                *lo = blo;
                *hi = bucket0_lo[2 * c0 + 1];
                return kmer0;
            }
        }
        return 0;
    }

    // Lean probe for the chaining loop: the chain only needs the match
    // length, the match's text position, and whether the match is
    // unique in the index — not the full SA range longest_match
    // reports.  One binary search (with the bucket's known 10-byte
    // prefix skipped in every compare) finds q's insertion point; the
    // longest prefix is attained at one of its two neighbors, and
    // uniqueness needs at most one more capped lcp against the winning
    // neighbor's other side.  Saves two full range searches per probe.
    struct Probe {
        i64 len;
        i64 pos;
        bool unique;
    };

    // `min_len`: matches shorter than this are rejected by the caller,
    // so their uniqueness is not computed (the flag is then meaningless).
    Probe probe_unique(const u8 *q, i64 qlen, i64 min_len = 0) const {
        if (qlen <= 0 || n == 0) return {0, 0, n == 1};

        i64 lo, hi;
        i64 skip = bucket_range(q, qlen, &lo, &hi);

        i64 at = lower_bound(q, qlen, lo, hi, skip);
        i64 left = (at > 0) ? lcp(suf(at - 1), q, qlen, qlen) : 0;
        i64 right = (at < n) ? lcp(suf(at), q, qlen, qlen) : 0;
        i64 len = std::max(left, right);
        if (len == 0) return {0, 0, n == 1};
        if (len < min_len) return {len, 0, false};  // rejected anyway
        if (left == right) return {len, suf(at), false};  // >= 2 carriers

        i64 w = (right == len) ? at : at - 1;
        i64 flank = (w == at) ? at + 1 : at - 2;
        bool unique = true;
        if (flank >= 0 && flank < n) {
            unique = lcp(suf(flank), q, qlen, len) < len;
        }
        return {len, suf(w), unique};
    }

    // longest_match: (l, i, j)
    void longest_match(const u8 *q, i64 qlen, i64 *out_l, i64 *out_i,
                       i64 *out_j) const {
        if (qlen <= 0 || n == 0) {
            *out_l = 0;
            *out_i = 0;
            *out_j = std::max(n - 1, (i64)0);
            return;
        }

        i64 lo, hi;
        bucket_range(q, qlen, &lo, &hi);

        i64 pos = lower_bound(q, qlen, lo, hi);
        i64 l = 0;
        if (pos < n) l = lcp(SA[pos], q, qlen, qlen);
        if (pos > 0) l = std::max(l, lcp(SA[pos - 1], q, qlen, qlen));

        if (l == 0) {
            *out_l = 0;
            *out_i = 0;
            *out_j = n - 1;
            return;
        }

        // range of suffixes with prefix q[0:l]: a chosen bucket of
        // width w is non-empty, hence l >= w and every l-sharer lies
        // inside it (full array when no bucket applies)
        i64 slo, shi;
        bucket_range(q, qlen, &slo, &shi);
        i64 i = lower_bound(q, l, slo, shi);
        i64 j = upper_bound(q, l, slo, shi) - 1;
        *out_l = l;
        *out_i = i;
        *out_j = j;
    }
};

// ---------------------------------------------------------------------------
// Anchor chaining.
//
// Behavioral spec (bit-parity with the reference is enforced by
// tests/test_oracle_parity.py and the Python oracle in core/anchors.py):
// scan the query left to right; an acceptable seed is either a unique
// index hit of at least `threshold` bases, or — cheaper — a plain text
// extension on the diagonal predicted by the previous seed.  Consecutive
// collinear seeds (same diagonal, same strand half of the doubled text)
// merge into one homology segment; a diagonal jump closes the open
// segment, which survives only if it was ever merge-extended or its
// founding seed was at least twice the threshold.
// ---------------------------------------------------------------------------

struct Hom {
    i64 direction;  // 0 fwd, 1 rev
    i64 ir;         // index_reference
    i64 irp;        // index_reference_projected
    i64 iq;         // index_query
    i64 len;

    i64 start() const { return irp; }
    i64 end() const { return irp + len; }
};

// Project a segment that lives in the reverse-complement half of the
// doubled index text back onto forward reference coordinates.
static void project_forward(Hom &h, i64 reference_length) {
    if (h.ir < reference_length) return;
    h.irp = 2 * reference_length + 1 - h.len - h.ir;
    h.direction = 1;
}

// A seed: query position, index-text position, match length.
struct Seed {
    i64 q = 0;
    i64 s = 0;
    i64 len = 0;
};

static std::vector<Hom> chain_anchors(const Index &idx, i64 threshold,
                                      const u8 *query, i64 qlen) {
    std::vector<Hom> segments;
    const i64 strand_border = idx.n / 2;

    Seed prev;               // last accepted seed
    bool merged = false;     // open segment absorbed a collinear seed
    Hom open{0, 0, 0, 0, 0};  // segment under construction

    auto keep_open = [&]() {
        if (merged || prev.len / 2 >= threshold) {
            project_forward(open, strand_border);
            segments.push_back(open);
        }
    };

    i64 cursor = 0;
    while (cursor < qlen) {
        i64 probe_len = 0;  // cursor stride comes from the last probe
        i64 hit_s = -1;

        // cheap probe: extend along the diagonal the previous seed
        // predicts, if the unseeded gap is small enough
        i64 diag_s = prev.s + (cursor - prev.q);
        bool diag_ok = diag_s < idx.n &&
                       cursor - (prev.q + prev.len) <= threshold;
        if (diag_ok) {
            probe_len =
                idx.lcp(diag_s, query + cursor, qlen - cursor, qlen - cursor);
            if (probe_len >= threshold) hit_s = diag_s;
        }
        if (hit_s < 0) {
            // full probe: longest index match, accepted only when unique
            auto pr =
                idx.probe_unique(query + cursor, qlen - cursor, threshold);
            probe_len = pr.len;
            if (pr.unique && probe_len >= threshold) hit_s = pr.pos;
        }

        if (hit_s >= 0) {
            i64 prev_end_s = prev.s + prev.len;
            i64 prev_end_q = prev.q + prev.len;
            bool collinear =
                hit_s > prev_end_s &&
                cursor - prev_end_q == hit_s - prev_end_s &&
                (hit_s < strand_border) == (prev.s < strand_border);
            if (collinear) {
                // same diagonal and strand: the open segment spans the
                // gap plus the new seed
                open.len += (cursor - prev_end_q) + probe_len;
                merged = true;
            } else {
                keep_open();
                open = Hom{0, hit_s, hit_s, cursor, probe_len};
                merged = false;
            }
            prev = Seed{cursor, hit_s, probe_len};
        }
        cursor += probe_len + 1;
    }

    // identical sequences: one seed covered the whole query
    if (prev.len >= qlen) open = Hom{0, prev.s, prev.s, 0, qlen};
    keep_open();

    return segments;
}

// Maximum-weight chain of non-overlapping segments (weight = bases).
// Classic weighted-interval DP over the start-sorted pile, O(n^2)
// predecessor scan; on score ties the earliest candidate wins, and the
// chain ending earliest wins overall (same tie-breaks the reference's
// filter exhibits, which parity requires).
static void filter_overlaps_max(std::vector<Hom> &pile) {
    const i64 count = (i64)pile.size();
    if (count < 2) return;

    std::vector<i64> chain_total(count, 0);  // best chain ending at i
    std::vector<i64> link(count, -1);        // previous chain member

    for (i64 i = 0; i < count; i++) {
        i64 best_prev = 0;
        for (i64 k = 0; k < i; k++) {
            if (pile[k].end() > pile[i].start()) continue;  // overlaps
            if (chain_total[k] > best_prev) {
                best_prev = chain_total[k];
                link[i] = k;
            }
        }
        chain_total[i] = best_prev + pile[i].len;
    }

    i64 champion = -1, champion_total = 0;
    for (i64 i = 0; i < count; i++) {
        if (chain_total[i] > champion_total) {
            champion_total = chain_total[i];
            champion = i;
        }
    }

    std::vector<u8> in_chain(count, 0);
    for (i64 i = champion; i >= 0; i = link[i]) in_chain[i] = 1;

    i64 w = 0;
    for (i64 r = 0; r < count; r++)
        if (in_chain[r]) pile[w++] = pile[r];
    pile.resize(w);
}

static std::vector<Hom> map_one(const Index &idx, i64 threshold, const u8 *q,
                                i64 qlen) {
    auto hv = chain_anchors(idx, threshold, q, qlen);
    std::stable_sort(hv.begin(), hv.end(), [](const Hom &a, const Hom &b) {
        return a.start() < b.start();
    });
    filter_overlaps_max(hv);
    return hv;
}

// ---------------------------------------------------------------------------
// Interleaved batch mapping (memory-level parallelism).
//
// A probe is ~4-6 DEPENDENT cache misses (bucket entry -> SA entry ->
// first text line of each neighbor lcp), so one chain runs at the DRAM
// latency floor (~350 ns/probe measured).  Different queries' chains are
// independent, though: this scheduler advances K chains in lock-step
// micro-steps, each step consuming one previously-prefetched datum and
// prefetching the next, so up to K misses are in flight at once instead
// of one.  The per-query probe/decision SEQUENCE is exactly
// chain_anchors' (bit-parity asserted against the scalar path and the
// Python oracle in tests/test_native.py / test_oracle_parity.py).
// ---------------------------------------------------------------------------

// env-gated mapping statistics (PHYLONIUM_TPU_NATIVE_TIMING): per-query
// counters accumulate into these under omp atomic at query completion
struct MapStats {
    i64 probes = 0;       // probe starts (NEXT entered with work)
    i64 diag_lcps = 0;    // diagonal fast-path lcps
    i64 diag_hits = 0;    // diag probes accepted (skipped full search)
    i64 searches = 0;     // full bucket+binary searches
    i64 bsteps = 0;       // binary-search compare steps
    i64 lcp_bytes = 0;    // bytes scanned by all lcps
};
static MapStats g_map_stats;

// deep profile (PHYLONIUM_TPU_NATIVE_TIMING=2): rdtsc cycles per
// state-machine phase, accumulated across all micro-steps.  The rdtsc
// pair itself costs ~30-60 cycles/step, so absolute numbers are
// inflated; the per-phase BREAKDOWN is what this is for.
static constexpr int N_PHASES = 14;
static i64 g_phase_cycles[N_PHASES];
static i64 g_phase_steps[N_PHASES];
static const char *const PHASE_NAMES[N_PHASES] = {
    "NEXT",    "DIAG",    "BUCKET",   "SEARCH_SA", "SEARCH_CMP",
    "NEI_SA",  "NEI_LCP", "FLANK_SA", "FLANK_LCP", "BSCAN_SA",
    "BSCAN_LCP", "APPLY", "IDLE",     "?",
};
static bool deep_timing() {
    static const bool v = [] {
        const char *e = std::getenv("PHYLONIUM_TPU_NATIVE_TIMING");
        return e && e[0] == '2';
    }();
    return v;
}

struct ChainRun {
    // which query
    const u8 *q = nullptr;
    i64 qlen = 0;
    i64 qidx = -1;
    MapStats st;

    // chain state (mirrors chain_anchors' locals exactly)
    Seed prev;
    bool merged = false;
    Hom open{0, 0, 0, 0, 0};
    std::vector<Hom> segs;
    i64 cursor = 0;

    // probe in flight
    enum Ph : u8 {
        NEXT, DIAG, BUCKET, SEARCH_SA, SEARCH_CMP,
        NEI_SA, NEI_LCP, FLANK_SA, FLANK_LCP,
        BSCAN_SA, BSCAN_LCP, APPLY, IDLE,
    } ph = IDLE;
    i64 lo = 0, hi = 0, skip = 0, mid = 0, at = 0;
    i64 mid_pos = 0, nei_l = 0, nei_r = 0, flank = 0, flank_pos = 0;
    i64 len = 0, wpos = 0, diag_s = 0;
    i64 probe_len = 0, hit_s = 0;
    i64 lead = 0;  // valid leading bases behind the stashed code
    bool unique = false;

    // bucket-scan probe: small buckets answer (len, pos, unique) by
    // scanning every member with all text misses in flight at once —
    // ~3 dependent-miss rounds instead of the binary search's ~10
    static constexpr i64 BSCAN_CAP = 32;
    i64 bpos[BSCAN_CAP];
};

static inline void pf(const void *p) { __builtin_prefetch(p, 0, 1); }

// Fold the probe's verdict into the chain state (chain_anchors' accept/
// merge/advance block; pure compute, no memory waits worth a yield).
static inline void apply_probe(const Index &idx, i64 threshold,
                               ChainRun &c) {
    const i64 strand_border = idx.n / 2;
    if (c.hit_s >= 0) {
        i64 prev_end_s = c.prev.s + c.prev.len;
        i64 prev_end_q = c.prev.q + c.prev.len;
        bool collinear =
            c.hit_s > prev_end_s &&
            c.cursor - prev_end_q == c.hit_s - prev_end_s &&
            (c.hit_s < strand_border) == (c.prev.s < strand_border);
        if (collinear) {
            c.open.len += (c.cursor - prev_end_q) + c.probe_len;
            c.merged = true;
        } else {
            if (c.merged || c.prev.len / 2 >= threshold) {
                Hom closed = c.open;
                project_forward(closed, strand_border);
                c.segs.push_back(closed);
            }
            c.open = Hom{0, c.hit_s, c.hit_s, c.cursor, c.probe_len};
            c.merged = false;
        }
        c.prev = Seed{c.cursor, c.hit_s, c.probe_len};
    }
    c.cursor += c.probe_len + 1;
}

// Kick off the next probe: issue its first-round prefetches (diag text
// and, speculatively, the bucket entry — the diag verdict isn't known
// yet, and a failed diag goes straight to the bucket next round).
// Returns false when the query is fully mapped (end-of-query close-out
// done; caller refills the slot).
static inline bool start_probe(const Index &idx, i64 threshold,
                               ChainRun &c) {
    if (c.cursor >= c.qlen) {
        const i64 strand_border = idx.n / 2;
        // identical sequences: one seed covered the whole query
        if (c.prev.len >= c.qlen)
            c.open = Hom{0, c.prev.s, c.prev.s, 0, c.qlen};
        if (c.merged || c.prev.len / 2 >= threshold) {
            project_forward(c.open, strand_border);
            c.segs.push_back(c.open);
        }
        return false;
    }
    c.st.probes++;
    c.probe_len = 0;
    c.hit_s = -1;
    c.diag_s = c.prev.s + (c.cursor - c.prev.q);
    i64 code;
    int v = idx.lead_code(c.q + c.cursor, c.qlen - c.cursor, &code);
    c.mid = code;  // stash for the bucket round
    c.lead = v;
    if (idx.has_buckets) {
        if (v == idx.kmer) pf(idx.bucket_lo.data() + 2 * code);
        if (idx.kmer0 && v >= idx.kmer0)  // speculative: primary may miss
            pf(idx.bucket0_lo.data() +
               2 * (code >> (2 * (v - idx.kmer0))));
    }
    bool diag_ok = c.diag_s < idx.n &&
                   c.cursor - (c.prev.q + c.prev.len) <= threshold;
    if (diag_ok) {
        pf(idx.S.data() + c.diag_s);
        pf(idx.S.data() + c.diag_s + 64);
        pf(idx.S.data() + c.diag_s + 128);
        c.ph = ChainRun::DIAG;
    } else {
        c.ph = ChainRun::BUCKET;
    }
    return true;
}

// Route a full probe into the bucket-scan or binary-search pipeline.
// Reads the bucket entry (prefetched by start_probe a round earlier)
// and issues the next round's SA prefetches.
static inline void enter_bucket(const Index &idx, ChainRun &c) {
    c.st.searches++;
    const i64 code = c.mid;
    const i64 v = c.lead;
    c.lo = 0;
    c.hi = idx.n;
    c.skip = 0;
    if (idx.has_buckets) {
        if (v == idx.kmer) {
            i64 blo = idx.bucket_lo[2 * code];
            if (blo >= 0) {
                c.lo = blo;
                c.hi = idx.bucket_lo[2 * code + 1];
                c.skip = idx.kmer;
            }
        }
        if (c.skip == 0 && idx.kmer0 && v >= idx.kmer0) {
            // empty/absent primary: the match is shorter than kmer,
            // so the k=10 secondary still holds every attainer
            i64 c0 = code >> (2 * (v - idx.kmer0));
            i64 blo = idx.bucket0_lo[2 * c0];
            if (blo >= 0) {
                c.lo = blo;
                c.hi = idx.bucket0_lo[2 * c0 + 1];
                c.skip = idx.kmer0;
            }
        }
        if (c.skip && c.hi - c.lo <= ChainRun::BSCAN_CAP) {
            // whole bucket fits the scan probe: kick off the
            // SA-range loads (contiguous, 1-2 lines)
            for (i64 i = c.lo; i < c.hi; i += 16)
                pf(idx.SA32.empty()
                       ? (const void *)(idx.SA.data() + i)
                       : (const void *)(idx.SA32.data() + i));
            c.ph = ChainRun::BSCAN_SA;
            return;
        }
    }
    c.mid = c.lo + (c.hi - c.lo) / 2;
    pf(idx.SA32.empty() ? (const void *)(idx.SA.data() + c.mid)
                        : (const void *)(idx.SA32.data() + c.mid));
    c.ph = ChainRun::SEARCH_SA;
}

// advance one chain by one micro-step; returns false when the query is
// fully mapped (caller refills the slot)
static bool chain_step(const Index &idx, i64 threshold, ChainRun &c) {
    const i64 strand_border = idx.n / 2;
    switch (c.ph) {
        case ChainRun::NEXT:
            return start_probe(idx, threshold, c);
        case ChainRun::DIAG: {
            c.probe_len = idx.lcp(c.diag_s, c.q + c.cursor,
                                  c.qlen - c.cursor, c.qlen - c.cursor);
            c.st.diag_lcps++;
            c.st.lcp_bytes += c.probe_len;
            if (c.probe_len >= threshold) {
                c.st.diag_hits++;
                c.hit_s = c.diag_s;
                apply_probe(idx, threshold, c);
                return start_probe(idx, threshold, c);
            }
            // failed diag: the bucket entry was prefetched at probe
            // start, so route into the search pipeline right now
            enter_bucket(idx, c);
            return true;
        }
        case ChainRun::BUCKET: {
            enter_bucket(idx, c);
            return true;
        }
        case ChainRun::SEARCH_SA: {
            c.mid_pos = idx.suf(c.mid);
            pf(idx.S.data() + c.mid_pos + c.skip);
            c.ph = ChainRun::SEARCH_CMP;
            return true;
        }
        case ChainRun::SEARCH_CMP: {
            c.st.bsteps++;
            const i64 plen = c.qlen - c.cursor;
            i64 l = idx.lcp_from(c.mid_pos, c.q + c.cursor, plen, plen,
                                 c.skip);
            c.st.lcp_bytes += l;
            int cmp;
            if (l == plen)
                cmp = 0;
            else if (c.mid_pos + l >= idx.n)
                cmp = -1;
            else
                cmp = (int)idx.S[c.mid_pos + l] - (int)c.q[c.cursor + l];
            if (cmp < 0)
                c.lo = c.mid + 1;
            else
                c.hi = c.mid;
            if (c.lo < c.hi) {
                c.mid = c.lo + (c.hi - c.lo) / 2;
                pf(idx.SA32.empty()
                       ? (const void *)(idx.SA.data() + c.mid)
                       : (const void *)(idx.SA32.data() + c.mid));
                c.ph = ChainRun::SEARCH_SA;
            } else {
                c.at = c.lo;
                if (c.at > 0)
                    pf(idx.SA32.empty()
                           ? (const void *)(idx.SA.data() + c.at - 1)
                           : (const void *)(idx.SA32.data() + c.at - 1));
                if (c.at < idx.n)
                    pf(idx.SA32.empty()
                           ? (const void *)(idx.SA.data() + c.at)
                           : (const void *)(idx.SA32.data() + c.at));
                c.ph = ChainRun::NEI_SA;
            }
            return true;
        }
        case ChainRun::NEI_SA: {
            c.nei_l = (c.at > 0) ? idx.suf(c.at - 1) : -1;
            c.nei_r = (c.at < idx.n) ? idx.suf(c.at) : -1;
            if (c.nei_l >= 0) pf(idx.S.data() + c.nei_l);
            if (c.nei_r >= 0) pf(idx.S.data() + c.nei_r);
            c.ph = ChainRun::NEI_LCP;
            return true;
        }
        case ChainRun::NEI_LCP: {
            const i64 plen = c.qlen - c.cursor;
            i64 left = (c.nei_l >= 0)
                           ? idx.lcp(c.nei_l, c.q + c.cursor, plen, plen)
                           : 0;
            i64 right = (c.nei_r >= 0)
                            ? idx.lcp(c.nei_r, c.q + c.cursor, plen, plen)
                            : 0;
            c.st.lcp_bytes += left + right;
            c.len = std::max(left, right);
            if (c.len == 0 || c.len < threshold) {
                c.probe_len = c.len;  // rejected (or no match at all)
                c.ph = ChainRun::APPLY;
                return true;
            }
            if (left == right) {  // >= 2 carriers: not unique
                c.probe_len = c.len;
                c.ph = ChainRun::APPLY;
                return true;
            }
            const bool right_wins = (right == c.len);
            c.wpos = right_wins ? c.nei_r : c.nei_l;
            c.flank = right_wins ? c.at + 1 : c.at - 2;
            if (c.flank >= 0 && c.flank < idx.n) {
                pf(idx.SA32.empty()
                       ? (const void *)(idx.SA.data() + c.flank)
                       : (const void *)(idx.SA32.data() + c.flank));
                c.ph = ChainRun::FLANK_SA;
            } else {
                c.probe_len = c.len;
                c.hit_s = c.wpos;  // unique
                c.ph = ChainRun::APPLY;
            }
            return true;
        }
        case ChainRun::BSCAN_SA: {
            // read every member's text position; fire all text misses
            const i64 b = c.hi - c.lo;
            for (i64 i = 0; i < b; i++) {
                c.bpos[i] = idx.suf(c.lo + i);
                pf(idx.S.data() + c.bpos[i] + c.skip);
            }
            c.ph = ChainRun::BSCAN_LCP;
            return true;
        }
        case ChainRun::BSCAN_LCP: {
            // all attainers of the max lcp share >= KMER bytes with q,
            // so they are exactly in this bucket: max/argmax/multiplicity
            // over the members reproduce the binary path's (len, pos,
            // unique) bit-exactly (suffixes outside share < KMER)
            const i64 plen = c.qlen - c.cursor;
            const i64 b = c.hi - c.lo;
            i64 best = 0, best_pos = -1, best_count = 0;
            for (i64 i = 0; i < b; i++) {
                i64 l = idx.lcp_from(c.bpos[i], c.q + c.cursor, plen, plen,
                                     c.skip);
                c.st.lcp_bytes += l - c.skip;
                if (l > best) {
                    best = l;
                    best_pos = c.bpos[i];
                    best_count = 1;
                } else if (l == best) {
                    best_count++;
                }
            }
            c.st.bsteps += b;
            c.probe_len = best;
            if (best >= threshold && best_count == 1) c.hit_s = best_pos;
            apply_probe(idx, threshold, c);
            return start_probe(idx, threshold, c);
        }
        case ChainRun::FLANK_SA: {
            c.flank_pos = idx.suf(c.flank);
            pf(idx.S.data() + c.flank_pos);
            c.ph = ChainRun::FLANK_LCP;
            return true;
        }
        case ChainRun::FLANK_LCP: {
            const i64 plen = c.qlen - c.cursor;
            bool unique =
                idx.lcp(c.flank_pos, c.q + c.cursor, plen, c.len) < c.len;
            c.probe_len = c.len;
            if (unique) c.hit_s = c.wpos;
            c.ph = ChainRun::APPLY;
            return true;
        }
        case ChainRun::APPLY: {
            apply_probe(idx, threshold, c);
            return start_probe(idx, threshold, c);
        }
        case ChainRun::IDLE:
        default:
            return false;
    }
}

// map queries [j0, j1) with K interleaved chains on this thread
static void map_batch_ilp(const Index &idx, i64 threshold,
                          const u8 *const *qptrs, const i64 *qlens,
                          i64 j0, i64 j1,
                          std::vector<std::vector<Hom>> &results,
                          i64 *progress) {
    // chains in flight per thread: enough to cover ~3 dependent-miss
    // rounds of latency; tunable for other hosts (measured sweep on
    // this box in docs/ARCHITECTURE.md)
    static const int K = [] {
        const char *e = std::getenv("PHYLONIUM_TPU_MAP_CHAINS");
        int v = e ? std::atoi(e) : 32;
        return v < 1 ? 1 : (v > 256 ? 256 : v);
    }();
    std::vector<ChainRun> runs(K);
    i64 next = j0;
    int active = 0;

    auto refill = [&](ChainRun &c) -> bool {
        if (next >= j1) return false;
        i64 j = next++;
        c = ChainRun{};
        c.q = qptrs[j];
        c.qlen = qlens[j];
        c.qidx = j;
        c.ph = ChainRun::NEXT;
        return true;
    };

    for (int k = 0; k < K; k++)
        if (refill(runs[k])) active++;

    const bool deep = deep_timing();
    i64 phase_cycles[N_PHASES] = {0};
    i64 phase_steps[N_PHASES] = {0};

    while (active > 0) {
        for (int k = 0; k < K; k++) {
            ChainRun &c = runs[k];
            if (c.ph == ChainRun::IDLE) continue;
            bool alive;
            if (deep) {
                const int ph = (int)c.ph < N_PHASES ? (int)c.ph
                                                    : N_PHASES - 1;
                const unsigned long long t0 = __builtin_ia32_rdtsc();
                alive = chain_step(idx, threshold, c);
                phase_cycles[ph] += (i64)(__builtin_ia32_rdtsc() - t0);
                phase_steps[ph]++;
            } else {
                alive = chain_step(idx, threshold, c);
            }
            if (!alive) {
                // query done: finish exactly like map_one
                std::stable_sort(
                    c.segs.begin(), c.segs.end(),
                    [](const Hom &a, const Hom &b) {
                        return a.start() < b.start();
                    });
                filter_overlaps_max(c.segs);
                results[c.qidx] = std::move(c.segs);
                if (std::getenv("PHYLONIUM_TPU_NATIVE_TIMING")) {
#ifdef _OPENMP
#pragma omp critical(map_stats)
#endif
                    {
                        g_map_stats.probes += c.st.probes;
                        g_map_stats.diag_lcps += c.st.diag_lcps;
                        g_map_stats.diag_hits += c.st.diag_hits;
                        g_map_stats.searches += c.st.searches;
                        g_map_stats.bsteps += c.st.bsteps;
                        g_map_stats.lcp_bytes += c.st.lcp_bytes;
                    }
                }
                if (progress) {
#ifdef _OPENMP
#pragma omp atomic
#endif
                    (*progress)++;
                }
                if (!refill(c)) {
                    c.ph = ChainRun::IDLE;
                    active--;
                }
            }
        }
    }

    if (deep) {
#ifdef _OPENMP
#pragma omp critical(map_phase_stats)
#endif
        for (int p = 0; p < N_PHASES; p++) {
            g_phase_cycles[p] += phase_cycles[p];
            g_phase_steps[p] += phase_steps[p];
        }
    }
}

// ---------------------------------------------------------------------------
// FASTA bodies
// ---------------------------------------------------------------------------

// pfasta's whitespace: ' ' and '\t' '\n' '\v' '\f' '\r' (0x09-0x0D)
inline bool fasta_space(u8 c) { return c == ' ' || (c >= '\t' && c <= '\r'); }

// Does p[0, n) hold a byte that is not whitespace?
bool fasta_has_word(const u8 *p, i64 n) {
    for (i64 i = 0; i < n; i++)
        if (!fasta_space(p[i])) return true;
    return false;
}

// The canonical nucleotides (ACGTacgt) of src[0, n), uppercased, into dst
// (the data model's filter_nucl, reference semantics
// src/sequence.cxx:109-146).  Writes exactly the kept bytes, so dst may be
// a destination of the exact filtered size.  Returns the filtered length.
i64 filter_nucl(const u8 *__restrict__ src, i64 n, u8 *__restrict__ dst) {
    i64 w = 0;
#if defined(__AVX512BW__) && defined(__AVX512VBMI2__)
    const __m512i vA = _mm512_set1_epi8('A'), vC = _mm512_set1_epi8('C');
    const __m512i vG = _mm512_set1_epi8('G'), vT = _mm512_set1_epi8('T');
    const __m512i vcase = _mm512_set1_epi8((char)0xDF);
    for (i64 i = 0; i < n; i += 64) {
        const i64 rem = n - i;
        const __mmask64 live =
            rem >= 64 ? ~0ULL : ((1ULL << rem) - 1);
        const __m512i up = _mm512_and_si512(
            _mm512_maskz_loadu_epi8(live, src + i), vcase);
        const __mmask64 keep =
            (_mm512_cmpeq_epi8_mask(up, vA) |
             _mm512_cmpeq_epi8_mask(up, vC) |
             _mm512_cmpeq_epi8_mask(up, vG) |
             _mm512_cmpeq_epi8_mask(up, vT)) & live;
        // compress in a register, then a masked store of the kept bytes
        // (a compressing store to memory is slow on some cores)
        const int kept = __builtin_popcountll(keep);
        const __mmask64 head = kept == 64 ? ~0ULL : ((1ULL << kept) - 1);
        _mm512_mask_storeu_epi8(dst + w, head,
                                _mm512_maskz_compress_epi8(keep, up));
        w += kept;
    }
#else
    u8 keep[256];
    std::memset(keep, 0, sizeof(keep));
    for (u8 c : {'A', 'C', 'G', 'T'}) {
        keep[c] = c;
        keep[c + 32] = c;  // lowercase folds up
    }
    for (i64 i = 0; i < n; i++)
        if (keep[src[i]]) dst[w++] = keep[src[i]];
#endif
    return w;
}

// The count of canonical nucleotides (ACGTacgt) in src[0, n): the length
// filter_nucl writes.
i64 count_nucl(const u8 *src, i64 n) {
    i64 kept = 0;
    i64 i = 0;
#if defined(__AVX512BW__)
    const __m512i vA = _mm512_set1_epi8('A'), vC = _mm512_set1_epi8('C');
    const __m512i vG = _mm512_set1_epi8('G'), vT = _mm512_set1_epi8('T');
    const __m512i vcase = _mm512_set1_epi8((char)0xDF);
    for (; i + 64 <= n; i += 64) {
        const __m512i up = _mm512_and_si512(
            _mm512_loadu_si512((const void *)(src + i)), vcase);
        kept += __builtin_popcountll(
            _mm512_cmpeq_epi8_mask(up, vA) | _mm512_cmpeq_epi8_mask(up, vC) |
            _mm512_cmpeq_epi8_mask(up, vG) | _mm512_cmpeq_epi8_mask(up, vT));
    }
#endif
    for (; i < n; i++) {
        const u8 up = src[i] & 0xDF;
        kept += up == 'A' || up == 'C' || up == 'G' || up == 'T';
    }
    return kept;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void *phy_index_build(const u8 *S, i64 m) {
    auto *idx = new Index();
    const double t0 = omp_get_wtime();
    idx->S.assign(S, S + m);
    idx->n = m;
    idx->build_sa();
    const double t1 = omp_get_wtime();
    if (!idx->SA32.empty()) idx->build_buckets(idx->build_threads);
    const double t2 = omp_get_wtime();
    idx->sais_s = t1 - t0;
    idx->buckets_s = t2 - t1;
    if (std::getenv("PHYLONIUM_TPU_NATIVE_TIMING")) {
        std::fprintf(stderr,
                     "native index: sais=%.3fs buckets=%.3fs (n=%lld, "
                     "%d threads, %d levels)\n",
                     idx->sais_s, idx->buckets_s, (long long)m,
                     idx->build_threads, idx->sais_levels);
    }
    return idx;
}

// The build's account: out[0] its OpenMP threads, out[1] the seconds of
// the suffix sort, out[2] those of the bucket tables and the i64 SA,
// out[3] the SA-IS levels that ran (1: no recursion).
void phy_index_stats(void *h, double *out) {
    const Index &idx = *static_cast<Index *>(h);
    out[0] = idx.build_threads;
    out[1] = idx.sais_s;
    out[2] = idx.buckets_s;
    out[3] = idx.sais_levels;
}

void phy_index_free(void *h) { delete static_cast<Index *>(h); }

i64 phy_index_size(void *h) { return static_cast<Index *>(h)->n; }

const i64 *phy_index_sa(void *h) {
    return static_cast<Index *>(h)->SA.data();
}

void phy_longest_match(void *h, const u8 *q, i64 qlen, i64 *out_lij) {
    static_cast<Index *>(h)->longest_match(q, qlen, out_lij, out_lij + 1,
                                           out_lij + 2);
}

// Lean probe used by the chaining loop; exposed so tests can assert its
// (len, pos, unique) agrees with longest_match's full-range answer.
void phy_probe_unique(void *h, const u8 *q, i64 qlen, i64 min_len,
                      i64 *out_lpu) {
    auto pr = static_cast<Index *>(h)->probe_unique(q, qlen, min_len);
    out_lpu[0] = pr.len;
    out_lpu[1] = pr.pos;
    out_lpu[2] = pr.unique ? 1 : 0;
}

// Map one query; returns number of homologies.  *out receives a malloc'd
// [n, 5] int64 array (direction, ir, irp, iq, len); free with phy_free.
i64 phy_map_query(void *h, const u8 *q, i64 qlen, i64 threshold, i64 **out) {
    auto hv = map_one(*static_cast<Index *>(h), threshold, q, qlen);
    i64 *buf = (i64 *)std::malloc(sizeof(i64) * 5 * std::max(hv.size(), (size_t)1));
    for (size_t k = 0; k < hv.size(); k++) {
        buf[5 * k + 0] = hv[k].direction;
        buf[5 * k + 1] = hv[k].ir;
        buf[5 * k + 2] = hv[k].irp;
        buf[5 * k + 3] = hv[k].iq;
        buf[5 * k + 4] = hv[k].len;
    }
    *out = buf;
    return (i64)hv.size();
}

// Batch mapping with OpenMP over queries.  Query j is read where it lies,
// qptrs[j][0, qlens[j]), with no slack past its last byte (`lcp` is bounded
// by the query's length, `lead_code` gates its 16-byte load on it).
// Returns a malloc'd buffer of all homologies concatenated; counts[j]
// receives each query's count.  `progress` (nullable) is atomically
// incremented per completed query so the caller can poll it for a live
// progress bar.
i64 phy_map_queries(void *h, const u8 *const *qptrs, const i64 *qlens,
                    i64 nq, i64 threshold, i64 *counts, i64 **out,
                    i64 *progress) {
    const Index &idx = *static_cast<Index *>(h);
    std::vector<std::vector<Hom>> results(nq);

    // default: interleaved chains (memory-level parallelism; ~2x per
    // core measured) with OpenMP over per-thread query ranges.
    // PHYLONIUM_TPU_MAP_ILP=0 restores the scalar per-query loop
    // (parity oracle; tests compare both).
    const char *ilp_env = std::getenv("PHYLONIUM_TPU_MAP_ILP");
    const bool use_ilp = !(ilp_env && ilp_env[0] == '0');
    if (use_ilp) {
#ifdef _OPENMP
#pragma omp parallel
        {
            const i64 nt = omp_get_num_threads();
            const i64 t = omp_get_thread_num();
            const i64 per = (nq + nt - 1) / nt;
            const i64 j0 = t * per;
            const i64 j1 = std::min(nq, j0 + per);
            if (j0 < j1)
                map_batch_ilp(idx, threshold, qptrs, qlens, j0, j1,
                              results, progress);
        }
#else
        map_batch_ilp(idx, threshold, qptrs, qlens, 0, nq, results,
                      progress);
#endif
    } else {
#pragma omp parallel for schedule(dynamic)
        for (i64 j = 0; j < nq; j++) {
            results[j] = map_one(idx, threshold, qptrs[j], qlens[j]);
            if (progress) {
#pragma omp atomic
                (*progress)++;
            }
        }
    }

    if (std::getenv("PHYLONIUM_TPU_NATIVE_TIMING")) {
        const MapStats &s = g_map_stats;
        std::fprintf(stderr,
                     "native map: probes=%lld diag_lcps=%lld (hit %lld) "
                     "searches=%lld bsteps=%lld lcp_bytes=%lld\n",
                     (long long)s.probes, (long long)s.diag_lcps,
                     (long long)s.diag_hits, (long long)s.searches,
                     (long long)s.bsteps, (long long)s.lcp_bytes);
        if (deep_timing()) {
            i64 tot_cy = 0, tot_steps = 0;
            for (int p = 0; p < N_PHASES; p++) {
                tot_cy += g_phase_cycles[p];
                tot_steps += g_phase_steps[p];
            }
            std::fprintf(stderr, "native map phases (%lld steps, "
                         "%.2f Gcy incl. rdtsc overhead):\n",
                         (long long)tot_steps, tot_cy / 1e9);
            for (int p = 0; p < N_PHASES; p++) {
                if (!g_phase_steps[p]) continue;
                std::fprintf(
                    stderr, "  %-10s steps=%-11lld cy/step=%-6.1f %5.1f%%\n",
                    PHASE_NAMES[p], (long long)g_phase_steps[p],
                    (double)g_phase_cycles[p] / g_phase_steps[p],
                    100.0 * g_phase_cycles[p] / tot_cy);
            }
        }
    }
    i64 total = 0;
    for (i64 j = 0; j < nq; j++) {
        counts[j] = (i64)results[j].size();
        total += counts[j];
    }
    i64 *buf = (i64 *)std::malloc(sizeof(i64) * 5 * std::max(total, (i64)1));
    i64 w = 0;
    for (i64 j = 0; j < nq; j++) {
        for (const auto &hm : results[j]) {
            buf[w++] = hm.direction;
            buf[w++] = hm.ir;
            buf[w++] = hm.irp;
            buf[w++] = hm.iq;
            buf[w++] = hm.len;
        }
    }
    *out = buf;
    return total;
}

void phy_free(void *p) { std::free(p); }

// ---------------------------------------------------------------------------
// Host pair counting over the pileup state matrix (cold-start fallback of
// the adaptive compare backend; the hot path is the Pallas kernel in
// phylonium_tpu/ops/pallas_match.py).  States are the 11-value encoding of
// core/pileup.py: base(5) x strand(2), INVALID = 10.
//
// Match rule (ops/match_table.py): same strand -> equal states; opposite
// strands -> one of six byte-complement pairs, including the '!'/T ASCII
// quirk.  Because states fit a nibble, the AVX2 path resolves the
// cross-strand rule with two in-register 16-entry shuffles per 32 columns
// instead of a table gather.
// ---------------------------------------------------------------------------

namespace {

constexpr u8 PILE_INVALID = 10;

// cross-strand partners: state s (one strand) matches partner_a/b[s] (the
// other strand); 0xFF = no partner.  T has two partners (A and the '!'
// quirk), every other base has at most one.
struct CrossTables {
    u8 a[16];
    u8 b[16];
};

static CrossTables make_cross_tables() {
    CrossTables t;
    const u8 bytes[5] = {'A', 'C', 'G', 'T', '!'};
    for (int s = 0; s < 16; s++) t.a[s] = t.b[s] = 0xFF;
    for (int s = 0; s < 10; s++) {
        int sb = bytes[s % 5], sd = s / 5;
        int slot = 0;
        for (int q = 0; q < 10; q++) {
            int qb = bytes[q % 5], qd = q / 5;
            if (sd == qd) continue;
            if (((sb ^ qb) & 6) == 4) {
                (slot++ ? t.b : t.a)[s] = (u8)q;
            }
        }
    }
    return t;
}

static const CrossTables CROSS = make_cross_tables();

// scalar tile: counts for one pair over [lo, hi) columns
static void count_pair_scalar(const u8 *a, const u8 *b, i64 len,
                              i64 *matches, i64 *valid) {
    i64 m = 0, v = 0;
    for (i64 k = 0; k < len; k++) {
        u8 x = a[k], y = b[k];
        bool ok = x != PILE_INVALID && y != PILE_INVALID;
        v += ok;
        m += (x == y && ok) || y == CROSS.a[x] || y == CROSS.b[x];
    }
    *matches += m;
    *valid += v;
}

}  // namespace

#ifdef __AVX2__
#include <immintrin.h>

namespace {

static void count_pair_avx2(const u8 *a, const u8 *b, i64 len, i64 *matches,
                            i64 *valid) {
    const __m256i inv = _mm256_set1_epi8((char)PILE_INVALID);
    const __m256i one = _mm256_set1_epi8(1);
    const __m256i zero = _mm256_setzero_si256();
    const __m128i ta = _mm_loadu_si128((const __m128i *)CROSS.a);
    const __m128i tb = _mm_loadu_si128((const __m128i *)CROSS.b);
    const __m256i cross_a = _mm256_broadcastsi128_si256(ta);
    const __m256i cross_b = _mm256_broadcastsi128_si256(tb);

    __m256i macc = _mm256_setzero_si256();
    __m256i vacc = _mm256_setzero_si256();

    i64 k = 0;
    for (; k + 32 <= len; k += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i *)(a + k));
        __m256i y = _mm256_loadu_si256((const __m256i *)(b + k));
        __m256i x_ok = _mm256_andnot_si256(
            _mm256_cmpeq_epi8(x, inv), _mm256_set1_epi8((char)0xFF));
        __m256i y_ok = _mm256_andnot_si256(
            _mm256_cmpeq_epi8(y, inv), _mm256_set1_epi8((char)0xFF));
        __m256i ok = _mm256_and_si256(x_ok, y_ok);
        // same-strand: equal states (both valid)
        __m256i same = _mm256_and_si256(_mm256_cmpeq_epi8(x, y), ok);
        // cross-strand: y equals one of x's complement partners
        __m256i p1 = _mm256_shuffle_epi8(cross_a, x);
        __m256i p2 = _mm256_shuffle_epi8(cross_b, x);
        __m256i cross = _mm256_or_si256(_mm256_cmpeq_epi8(y, p1),
                                        _mm256_cmpeq_epi8(y, p2));
        __m256i match = _mm256_or_si256(same, cross);
        // psadbw of 0/1 bytes gives exact per-64-bit-lane sums
        macc = _mm256_add_epi64(
            macc, _mm256_sad_epu8(_mm256_and_si256(match, one), zero));
        vacc = _mm256_add_epi64(
            vacc, _mm256_sad_epu8(_mm256_and_si256(ok, one), zero));
    }

    alignas(32) i64 tmp[4];
    _mm256_store_si256((__m256i *)tmp, macc);
    i64 m = tmp[0] + tmp[1] + tmp[2] + tmp[3];
    _mm256_store_si256((__m256i *)tmp, vacc);
    i64 v = tmp[0] + tmp[1] + tmp[2] + tmp[3];
    *matches += m;
    *valid += v;
    if (k < len) count_pair_scalar(a + k, b + k, len - k, matches, valid);
}

}  // namespace
#endif  // __AVX2__

#ifdef __AVX512BW__
namespace {

// AVX-512BW variant: 64 columns per iteration, and the 0/1 counting
// collapses into mask-register popcounts (no byte accumulators, no
// psadbw reduction).  The library builds with -march=native on the
// machine it runs on, so this is compile-time selected.
static void count_pair_avx512(const u8 *a, const u8 *b, i64 len,
                              i64 *matches, i64 *valid) {
    const __m512i inv = _mm512_set1_epi8((char)PILE_INVALID);
    const __m128i ta = _mm_loadu_si128((const __m128i *)CROSS.a);
    const __m128i tb = _mm_loadu_si128((const __m128i *)CROSS.b);
    const __m512i cross_a = _mm512_broadcast_i32x4(ta);
    const __m512i cross_b = _mm512_broadcast_i32x4(tb);

    i64 m = 0, v = 0;
    i64 k = 0;
    for (; k + 64 <= len; k += 64) {
        __m512i x = _mm512_loadu_si512((const void *)(a + k));
        __m512i y = _mm512_loadu_si512((const void *)(b + k));
        __mmask64 ok = _mm512_cmpneq_epi8_mask(x, inv) &
                       _mm512_cmpneq_epi8_mask(y, inv);
        // same-strand: equal states (both valid)
        __mmask64 same = _mm512_cmpeq_epi8_mask(x, y) & ok;
        // cross-strand: y equals one of x's complement partners
        // (vpshufb per 128-bit lane, same table as the AVX2 path)
        __mmask64 cross =
            _mm512_cmpeq_epi8_mask(y, _mm512_shuffle_epi8(cross_a, x)) |
            _mm512_cmpeq_epi8_mask(y, _mm512_shuffle_epi8(cross_b, x));
        m += (i64)__builtin_popcountll((unsigned long long)(same | cross));
        v += (i64)__builtin_popcountll((unsigned long long)ok);
    }
    *matches += m;
    *valid += v;
    if (k < len) count_pair_scalar(a + k, b + k, len - k, matches, valid);
}

}  // namespace
#endif  // __AVX512BW__

#if defined(__AVX512BW__) && defined(__AVX512VPOPCNTDQ__)
namespace {

// ---------------------------------------------------------------------------
// Bitplane counting path: raises the byte kernel's compute ceiling.
//
// Each genome's chunk is transposed into 6 one-hot planes (A/C/G/T base
// one-hot regardless of strand; strand; valid), blocked 512 columns at a
// time (6 planes x 64 B per block, genome-major), i.e. 0.75 bytes/column
// vs the byte domain's 1.  Per pair and 512-column block the match rule
// collapses to ~16 vector ops via vpternlogq OR-of-AND folds and a
// strand select, counted with vpopcntq:
//
//   same  = (Ai&Aj)|(Ci&Cj)|(Gi&Gj)|(Ti&Tj)         equal bases
//   cross = (Ai&Tj)|(Ti&Aj)|(Ci&Gj)|(Gi&Cj)         complement pairs
//   match = (strand_i ^ strand_j ? cross : same) & Vi & Vj
//
// '!' separator states (base 4, either strand) carry no base plane, so
// the plane kernel scores every column where either side is '!' as a
// non-match; their true (rare — one per contig border, incl. the '!'/T
// quirk) contributions are re-scored scalar from sparse per-genome
// column lists.  Bit-identical to the byte path for states 0..10.
// ---------------------------------------------------------------------------

constexpr i64 PLANE_BLOCK = 512;           // columns per block
constexpr i64 PLANE_BLOCK_BYTES = 6 * 64;  // bytes per block per genome

// one genome's planes for `cols` columns of s into out (caller-zeroed,
// (ceil(cols/512) blocks); '!' column indices (relative) appended to seps
static void build_planes_row(const u8 *s, i64 cols, u8 *out,
                             std::vector<i64> *seps) {
    const __m512i v5 = _mm512_set1_epi8(5), v9 = _mm512_set1_epi8(9);
    const __m512i vinv = _mm512_set1_epi8((char)PILE_INVALID);
    const i64 ngrp = (cols + 63) / 64;
    for (i64 g = 0; g < ngrp; g++) {
        const i64 base_col = g * 64;
        const i64 rem = cols - base_col;
        const __mmask64 live =
            rem >= 64 ? ~0ULL : ((1ULL << rem) - 1);
        const __m512i x = _mm512_maskz_loadu_epi8(live, s + base_col);
        // dead lanes read as state 0 (A/fwd): mask A and valid by live
        const __mmask64 kA =
            (_mm512_cmpeq_epi8_mask(x, _mm512_setzero_si512()) |
             _mm512_cmpeq_epi8_mask(x, v5)) & live;
        const __mmask64 kC =
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(1)) |
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(6));
        const __mmask64 kG =
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(2)) |
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(7));
        const __mmask64 kT =
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(3)) |
            _mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(8));
        const __mmask64 kS =
            _mm512_cmp_epu8_mask(x, v5, _MM_CMPINT_NLT) &
            _mm512_cmp_epu8_mask(x, v9, _MM_CMPINT_LE);
        const __mmask64 kV = _mm512_cmpneq_epi8_mask(x, vinv) & live;
        u8 *blk = out + (g / 8) * PLANE_BLOCK_BYTES + (g % 8) * 8;
        const unsigned long long words[6] = {kA, kC, kG, kT, kS, kV};
        for (int p = 0; p < 6; p++)
            std::memcpy(blk + p * 64, &words[p], 8);
        __mmask64 kX =
            (_mm512_cmpeq_epi8_mask(x, _mm512_set1_epi8(4)) |
             _mm512_cmpeq_epi8_mask(x, v9)) & live;
        while (kX) {
            seps->push_back(base_col + __builtin_ctzll(kX));
            kX &= kX - 1;
        }
    }
}

// counts for one pair over nblk plane blocks
static void count_pair_planes(const u8 *pa, const u8 *pb, i64 nblk,
                              i64 *matches, i64 *valid) {
    __m512i macc = _mm512_setzero_si512();
    __m512i vacc = _mm512_setzero_si512();
    for (i64 b = 0; b < nblk;
         b++, pa += PLANE_BLOCK_BYTES, pb += PLANE_BLOCK_BYTES) {
        const __m512i Ai = _mm512_loadu_si512(pa + 0);
        const __m512i Ci = _mm512_loadu_si512(pa + 64);
        const __m512i Gi = _mm512_loadu_si512(pa + 128);
        const __m512i Ti = _mm512_loadu_si512(pa + 192);
        const __m512i Si = _mm512_loadu_si512(pa + 256);
        const __m512i Vi = _mm512_loadu_si512(pa + 320);
        const __m512i Aj = _mm512_loadu_si512(pb + 0);
        const __m512i Cj = _mm512_loadu_si512(pb + 64);
        const __m512i Gj = _mm512_loadu_si512(pb + 128);
        const __m512i Tj = _mm512_loadu_si512(pb + 192);
        const __m512i Sj = _mm512_loadu_si512(pb + 256);
        const __m512i Vj = _mm512_loadu_si512(pb + 320);
        // 0xF8 = a | (b & c): fold one AND+OR per ternlog
        __m512i same = _mm512_and_si512(Ai, Aj);
        same = _mm512_ternarylogic_epi64(same, Ci, Cj, 0xF8);
        same = _mm512_ternarylogic_epi64(same, Gi, Gj, 0xF8);
        same = _mm512_ternarylogic_epi64(same, Ti, Tj, 0xF8);
        __m512i cross = _mm512_and_si512(Ai, Tj);
        cross = _mm512_ternarylogic_epi64(cross, Ti, Aj, 0xF8);
        cross = _mm512_ternarylogic_epi64(cross, Ci, Gj, 0xF8);
        cross = _mm512_ternarylogic_epi64(cross, Gi, Cj, 0xF8);
        const __m512i sd = _mm512_xor_si512(Si, Sj);
        // 0xCA = a ? b : c
        const __m512i sel =
            _mm512_ternarylogic_epi64(sd, cross, same, 0xCA);
        const __m512i vv = _mm512_and_si512(Vi, Vj);
        const __m512i mm = _mm512_and_si512(sel, vv);
        macc = _mm512_add_epi64(macc, _mm512_popcnt_epi64(mm));
        vacc = _mm512_add_epi64(vacc, _mm512_popcnt_epi64(vv));
    }
    *matches += (i64)_mm512_reduce_add_epi64(macc);
    *valid += (i64)_mm512_reduce_add_epi64(vacc);
}

// true match count over the union of two sorted '!' column lists (the
// plane kernel scored all of these 0); same scalar rule as
// count_pair_scalar, one column at a time
static i64 sep_correction(const u8 *a, const u8 *b,
                          const std::vector<i64> &sa,
                          const std::vector<i64> &sb) {
    i64 extra = 0;
    size_t p = 0, q = 0;
    while (p < sa.size() || q < sb.size()) {
        i64 c;
        if (p < sa.size() && (q >= sb.size() || sa[p] <= sb[q]))
            c = sa[p];
        else
            c = sb[q];
        if (p < sa.size() && sa[p] == c) p++;
        if (q < sb.size() && sb[q] == c) q++;
        const u8 x = a[c], y = b[c];
        const bool ok = x != PILE_INVALID && y != PILE_INVALID;
        extra += (x == y && ok) || y == CROSS.a[x] || y == CROSS.b[x];
    }
    return extra;
}

static void pair_counts_planes(const u8 *states, i64 n, i64 stride,
                               i64 col_lo, i64 col_hi, i64 *subs,
                               i64 *homs) {
    const i64 len = col_hi - col_lo;
    const i64 nblk = (len + PLANE_BLOCK - 1) / PLANE_BLOCK;
    const i64 row_bytes = nblk * PLANE_BLOCK_BYTES;
    std::vector<u8> planes_buf((size_t)(n * row_bytes) + 64, 0);
    u8 *pl = planes_buf.data();
    pl += (64 - ((uintptr_t)pl & 63)) & 63;

    std::vector<std::vector<i64>> seps((size_t)n);
#pragma omp parallel for schedule(static)
    for (i64 g = 0; g < n; g++)
        build_planes_row(states + g * stride + col_lo, len,
                         pl + g * row_bytes, &seps[(size_t)g]);
    bool any_seps = false;
    for (const auto &v : seps)
        if (!v.empty()) any_seps = true;

    // same two-level tiling as the byte path (see phy_pair_counts)
    const i64 TI = 8;
    const i64 STRIP_BLKS = 64;  // 32768 cols; 16 rows x 24 KB = 384 KB
    const i64 nt = (n + TI - 1) / TI;
    std::vector<std::pair<i64, i64>> tiles;
    tiles.reserve((size_t)(nt * (nt + 1) / 2));
    for (i64 ti = 0; ti < nt; ti++)
        for (i64 tj = ti; tj < nt; tj++) tiles.emplace_back(ti, tj);

#pragma omp parallel for schedule(dynamic)
    for (i64 tp = 0; tp < (i64)tiles.size(); tp++) {
        const i64 i_lo = tiles[(size_t)tp].first * TI;
        const i64 j_lo = tiles[(size_t)tp].second * TI;
        const i64 i_hi = std::min(i_lo + TI, n);
        const i64 j_hi = std::min(j_lo + TI, n);
        i64 m_acc[TI * TI] = {0}, v_acc[TI * TI] = {0};
        for (i64 sb = 0; sb < nblk; sb += STRIP_BLKS) {
            const i64 bl = std::min(STRIP_BLKS, nblk - sb);
            for (i64 i = i_lo; i < i_hi; i++) {
                const u8 *pa = pl + i * row_bytes + sb * PLANE_BLOCK_BYTES;
                for (i64 j = std::max(j_lo, i + 1); j < j_hi; j++) {
                    const u8 *pb =
                        pl + j * row_bytes + sb * PLANE_BLOCK_BYTES;
                    count_pair_planes(
                        pa, pb, bl,
                        &m_acc[(i - i_lo) * TI + (j - j_lo)],
                        &v_acc[(i - i_lo) * TI + (j - j_lo)]);
                }
            }
        }
        for (i64 i = i_lo; i < i_hi; i++)
            for (i64 j = std::max(j_lo, i + 1); j < j_hi; j++) {
                i64 m = m_acc[(i - i_lo) * TI + (j - j_lo)];
                const i64 v = v_acc[(i - i_lo) * TI + (j - j_lo)];
                if (any_seps &&
                    (!seps[(size_t)i].empty() || !seps[(size_t)j].empty()))
                    m += sep_correction(states + i * stride + col_lo,
                                        states + j * stride + col_lo,
                                        seps[(size_t)i], seps[(size_t)j]);
                subs[i * n + j] += v - m;
                subs[j * n + i] += v - m;
                homs[i * n + j] += v;
                homs[j * n + i] += v;
            }
    }
}

// plane path wins once the O(n L) plane build amortizes over O(n^2)
// pair work (crossover ~n=19 measured; margin below).  Env override
// for tests and benches: PHYLONIUM_TPU_HOST_KERNEL={byte,planes}.
static bool use_plane_kernel(i64 n) {
    const char *e = std::getenv("PHYLONIUM_TPU_HOST_KERNEL");
    if (e && std::strcmp(e, "byte") == 0) return false;
    if (e && std::strcmp(e, "planes") == 0) return true;
    return n >= 24;
}

}  // namespace
#endif  // __AVX512BW__ && __AVX512VPOPCNTDQ__

// Split-layout nibble packing of the pileup (the host side of the packed
// device path, see ops/pallas_match.pack_states): byte [g, j] =
// state[g, j] | state[g, j + ceil(L/2)] << 4, INVALID-padded.  One pass,
// OpenMP over rows; replaces a multi-temporary numpy formulation that
// cost seconds at 1000-genome scale.
void phy_pack_states(const u8 *__restrict__ states, i64 n, i64 length,
                     i64 n_pad, i64 width, u8 *__restrict__ out) {
    const u8 pad_byte = PILE_INVALID | (PILE_INVALID << 4);
    const i64 l2 = (length + 1) / 2;
#pragma omp parallel for schedule(static)
    for (i64 g = 0; g < n_pad; g++) {
        u8 *row = out + g * width;
        if (g >= n) {
            std::memset(row, pad_byte, (size_t)width);
            continue;
        }
        const u8 *__restrict__ src = states + g * length;
        const u8 *__restrict__ src_hi = states + g * length + l2;
        const i64 hi_len = length - l2;  // second half may be shorter
        i64 k = 0;
        for (; k < hi_len; k++) row[k] = src[k] | (u8)(src_hi[k] << 4);
        for (; k < l2; k++) row[k] = src[k] | (u8)(PILE_INVALID << 4);
        if (width > l2)
            std::memset(row + l2, pad_byte, (size_t)(width - l2));
    }
}

// 2-bit pack of concatenated queries + '!' separator positions (the
// host side of the streamed device-pileup shipping path,
// ops/pileup_device.pack_queries): codes A=0 C=1 G=2 T=3, four per
// byte little-endian; '!' bytes pack as 0 and their global positions
// in the concatenated stream are recorded.  Returns the separator
// count — a caller whose sep buffer was too small retries with a
// bigger one (positions beyond sep_cap are not written).  Replaces a
// multi-pass numpy formulation that cost ~2 s per 128-genome group on
// a 1-core host (the feed worker's dominant cost).
i64 phy_pack2(const u8 *const *qptrs, const i64 *qlens, i64 nq,
              u8 *__restrict__ packed, i64 packed_len,
              i64 *__restrict__ sep_out, i64 sep_cap) {
    std::memset(packed, 0, (size_t)packed_len);
    u8 code_of[256] = {0};
    code_of['C'] = 1;
    code_of['G'] = 2;
    code_of['T'] = 3;
    i64 pos = 0, nsep = 0;
    for (i64 qi = 0; qi < nq; qi++) {
        const u8 *__restrict__ q = qptrs[qi];
        const i64 len = qlens[qi];
        for (i64 k = 0; k < len; k++, pos++) {
            const u8 b = q[k];
            if (b == '!') {
                if (nsep < sep_cap) sep_out[nsep] = pos;
                nsep++;
            }
            packed[pos >> 2] |= (u8)(code_of[b] << ((pos & 3) * 2));
        }
    }
    return nsep;
}

// Reference-projected pileup construction (the host side of
// core/pileup.py): fill each genome's row of per-reference-column
// states from its homology records.  Records are (direction, iq, start,
// len) int64 quads, concatenated across genomes with hom_counts[g]
// records each; queries are concatenated in qdata with qoffsets.
// Returns 0, or 1 + sets *bad_byte when a query byte is outside the
// filtered alphabet (caller raises).
#ifdef __AVX512VBMI__
namespace {

// 64-entry byte→code table indexed by (byte & 63): 'A'&63=1, 'C'&63=3,
// 'G'&63=7, 'T'&63=20, '!'&63=33 — all distinct, so after validation a
// single vpermb translates 64 query bytes to pileup codes.
struct PileLut {
    alignas(64) u8 code[64];
    alignas(64) u8 rev[64];  // byte-reverse permutation 63..0
};

static PileLut make_pile_lut() {
    PileLut t;
    std::memset(t.code, 0, sizeof(t.code));
    const char *bases = "ACGT!";
    for (int c = 0; c < 5; c++) t.code[(u8)bases[c] & 63] = (u8)c;
    for (int i = 0; i < 64; i++) t.rev[i] = (u8)(63 - i);
    return t;
}

static const PileLut PILE_LUT = make_pile_lut();

// true iff every byte of q is in {A,C,G,T,'!'}; else *bad = offender
static bool pile_validate_avx512(const u8 *q, i64 n, u8 *bad) {
    const __m512i vA = _mm512_set1_epi8('A'), vC = _mm512_set1_epi8('C');
    const __m512i vG = _mm512_set1_epi8('G'), vT = _mm512_set1_epi8('T');
    const __m512i vX = _mm512_set1_epi8('!');
    i64 k = 0;
    for (; k + 64 <= n; k += 64) {
        __m512i x = _mm512_loadu_si512((const void *)(q + k));
        __mmask64 ok = _mm512_cmpeq_epi8_mask(x, vA) |
                       _mm512_cmpeq_epi8_mask(x, vC) |
                       _mm512_cmpeq_epi8_mask(x, vG) |
                       _mm512_cmpeq_epi8_mask(x, vT) |
                       _mm512_cmpeq_epi8_mask(x, vX);
        if (ok != ~0ULL) {
            *bad = q[k + __builtin_ctzll(~(unsigned long long)ok)];
            return false;
        }
    }
    for (; k < n; k++) {
        u8 c = q[k];
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T' && c != '!') {
            *bad = c;
            return false;
        }
    }
    return true;
}

}  // namespace
#endif  // __AVX512VBMI__

int phy_build_pileup(const u8 *const *qptrs, const i64 *qlens,
                     const i64 *homs, const i64 *hom_counts, i64 n,
                     i64 ref_len, u8 *out, i64 *bad_byte) {
    int8_t code_of[256];
    std::memset(code_of, -1, sizeof(code_of));
    const char *bases = "ACGT!";
    for (int c = 0; c < 5; c++) code_of[(u8)bases[c]] = (int8_t)c;

    std::vector<i64> hom_offsets(n + 1, 0);
    for (i64 g = 0; g < n; g++)
        hom_offsets[g + 1] = hom_offsets[g] + hom_counts[g];

    int failed = 0;
#pragma omp parallel for schedule(dynamic)
    for (i64 g = 0; g < n; g++) {
        u8 *row = out + g * ref_len;
        // Rows are ~fully covered by disjoint, start-sorted spans
        // (filter_overlaps_max), so memsetting the whole row and then
        // overwriting ~99% of it doubles the write traffic; when the
        // spans verify as sorted/disjoint/in-bounds, fill only the
        // gaps.  Anything irregular falls back to the full memset.
        bool gap_fill = true;
        {
            i64 cur = 0;
            for (i64 r = hom_offsets[g]; r < hom_offsets[g + 1]; r++) {
                const i64 *rec = homs + 4 * r;
                i64 start = rec[2], len = rec[3];
                if (len <= 0) continue;
                if (start < cur || start + len > ref_len) {
                    gap_fill = false;
                    break;
                }
                cur = start + len;
            }
        }
        if (!gap_fill) std::memset(row, PILE_INVALID, (size_t)ref_len);
        i64 cursor = 0;
        const u8 *q = qptrs[g];
        const i64 qlen = qlens[g];
        // validate the whole query up front (same contract as
        // core/pileup.byte_to_code, which codes the full sequence)
        bool bad = false;
#ifdef __AVX512VBMI__
        u8 offender = 0;
        if (!pile_validate_avx512(q, qlen, &offender)) {
#pragma omp critical
            {
                failed = 1;
                *bad_byte = offender;
            }
            bad = true;
        }
#else
        for (i64 t = 0; t < qlen; t++) {
            if (code_of[q[t]] < 0) {
#pragma omp critical
                {
                    failed = 1;
                    *bad_byte = q[t];
                }
                bad = true;
                break;
            }
        }
#endif
        if (bad) {
            if (gap_fill)
                std::memset(row, PILE_INVALID, (size_t)ref_len);
            continue;
        }
        for (i64 r = hom_offsets[g]; r < hom_offsets[g + 1]; r++) {
            const i64 *rec = homs + 4 * r;
            i64 dir = rec[0], iq = rec[1], start = rec[2], len = rec[3];
            if (len <= 0) continue;
            if (gap_fill) {
                if (start > cursor)
                    std::memset(row + cursor, PILE_INVALID,
                                (size_t)(start - cursor));
                cursor = start + len;
            }
#ifdef __AVX512VBMI__
            // vpermb translate: 64 bytes/iter (reverse spans also flip
            // byte order in-register); tails fall to the scalar loop
            const __m512i lut = _mm512_load_si512((const void *)PILE_LUT.code);
            const __m512i rev = _mm512_load_si512((const void *)PILE_LUT.rev);
            const __m512i m63 = _mm512_set1_epi8(63);
            const __m512i five = _mm512_set1_epi8(5);
            i64 k = 0;
            if (dir) {
                const u8 *src = q + iq;
                for (; k + 64 <= len; k += 64) {
                    __m512i x = _mm512_loadu_si512(
                        (const void *)(src + len - k - 64));
                    x = _mm512_permutexvar_epi8(rev, x);
                    __m512i codes = _mm512_add_epi8(
                        _mm512_permutexvar_epi8(
                            _mm512_and_si512(x, m63), lut),
                        five);
                    _mm512_storeu_si512((void *)(row + start + k), codes);
                }
                const u8 *bsrc = q + iq + len - 1;
                for (; k < len; k++)
                    row[start + k] = (u8)(code_of[bsrc[-k]] + 5);
            } else {
                const u8 *src = q + iq;
                for (; k + 64 <= len; k += 64) {
                    __m512i x =
                        _mm512_loadu_si512((const void *)(src + k));
                    __m512i codes = _mm512_permutexvar_epi8(
                        _mm512_and_si512(x, m63), lut);
                    _mm512_storeu_si512((void *)(row + start + k), codes);
                }
                for (; k < len; k++)
                    row[start + k] = (u8)code_of[src[k]];
            }
#else
            if (dir) {
                const u8 *src = q + iq + len - 1;
                // ref column start+k aligns with query byte iq+len-1-k
                // (core/pileup.py build_pileup_row)
                for (i64 k = 0; k < len; k++)
                    row[start + k] = (u8)(code_of[src[-k]] + 5);
            } else {
                const u8 *src = q + iq;
                for (i64 k = 0; k < len; k++)
                    row[start + k] = (u8)code_of[src[k]];
            }
#endif
        }
        if (gap_fill && cursor < ref_len)
            std::memset(row + cursor, PILE_INVALID,
                        (size_t)(ref_len - cursor));
    }
    return failed;
}

// All-pairs (substitutions, homologs) over pileup columns [col_lo, col_hi).
// `states` is the row-major [n, stride] uint8 matrix; counts ACCUMULATE
// into subs/homs (callers zero them first and may chunk the column range
// to poll for a faster backend between calls).
//
// Blocking: per pair the kernel streams 2 bytes/column; with the naive
// pair loop both rows come from L3 (or DRAM) every time, and measured
// throughput drops from ~22 Gcol/s (L2-resident) to ~14.5 (L3) / ~6
// (DRAM) on this host.  Tiling pairs into TI x TI row tiles and columns
// into L2-sized strips computes TI pair-rows per strip load, cutting
// the L3/DRAM traffic ~TI-fold so the kernel stays compute-bound.
// Counts are exact integer sums, so any evaluation order is
// bit-identical to the naive loop.
void phy_pair_counts(const u8 *states, i64 n, i64 stride, i64 col_lo,
                     i64 col_hi, i64 *subs, i64 *homs) {
    i64 len = col_hi - col_lo;
    if (len <= 0 || n <= 0) return;

#if defined(__AVX512BW__) && defined(__AVX512VPOPCNTDQ__)
    if (use_plane_kernel(n)) {
        pair_counts_planes(states, n, stride, col_lo, col_hi, subs, homs);
        return;
    }
#endif

    const i64 TI = 8;          // row-tile side
    const i64 STRIP = 32768;   // 2*TI rows x STRIP cols = 512 KB (~L2)

    // upper-triangle tile pairs, flattened for the parallel loop
    const i64 nt = (n + TI - 1) / TI;
    std::vector<std::pair<i64, i64>> tiles;
    tiles.reserve((size_t)(nt * (nt + 1) / 2));
    for (i64 ti = 0; ti < nt; ti++)
        for (i64 tj = ti; tj < nt; tj++) tiles.emplace_back(ti, tj);

#pragma omp parallel for schedule(dynamic)
    for (i64 tp = 0; tp < (i64)tiles.size(); tp++) {
        const i64 i_lo = tiles[(size_t)tp].first * TI;
        const i64 j_lo = tiles[(size_t)tp].second * TI;
        const i64 i_hi = std::min(i_lo + TI, n);
        const i64 j_hi = std::min(j_lo + TI, n);
        i64 m_acc[TI * TI] = {0}, v_acc[TI * TI] = {0};
        for (i64 s = col_lo; s < col_hi; s += STRIP) {
            const i64 slen = std::min(STRIP, col_hi - s);
            for (i64 i = i_lo; i < i_hi; i++) {
                const u8 *a = states + i * stride + s;
                for (i64 j = std::max(j_lo, i + 1); j < j_hi; j++) {
                    const u8 *b = states + j * stride + s;
                    i64 *m = &m_acc[(i - i_lo) * TI + (j - j_lo)];
                    i64 *v = &v_acc[(i - i_lo) * TI + (j - j_lo)];
#if defined(__AVX512BW__)
                    count_pair_avx512(a, b, slen, m, v);
#elif defined(__AVX2__)
                    count_pair_avx2(a, b, slen, m, v);
#else
                    count_pair_scalar(a, b, slen, m, v);
#endif
                }
            }
        }
        for (i64 i = i_lo; i < i_hi; i++)
            for (i64 j = std::max(j_lo, i + 1); j < j_hi; j++) {
                const i64 m = m_acc[(i - i_lo) * TI + (j - j_lo)];
                const i64 v = v_acc[(i - i_lo) * TI + (j - j_lo)];
                subs[i * n + j] += v - m;
                subs[j * n + i] += v - m;
                homs[i * n + j] += v;
                homs[j * n + i] += v;
            }
    }
}

// Standalone suffix array for tests: fills out[n].
void phy_build_sa(const u8 *s, i64 n, i64 *out) {
    auto sa = build_sa_bytes(s, n);
    std::memcpy(out, sa.data(), sizeof(i64) * n);
}

// Keep only ACGT/acgt bytes, uppercased (data/sequence.filter_nucl).
// Returns the filtered length.
i64 phy_filter_nucl(const u8 *__restrict__ src, i64 n,
                    u8 *__restrict__ dst) {
    return filter_nucl(src, n, dst);
}

// Where pfasta rejects a file (io/fasta.py words each one, with its line).
enum : i64 {
    FASTA_EMPTY = -1,           // the file is empty
    FASTA_NO_START = -2,        // it does not start with '>'
    FASTA_EMPTY_NAME = -3,      // a header holds only whitespace
    FASTA_EMPTY_SEQUENCE = -4,  // a body holds only whitespace
};

// Lays out one FASTA file held whole in src[0, n) by pfasta's rules
// (io/fasta.py's _Parser): a record opens at a '>' that starts a line;
// its header runs to the end of that line, its body to the next record.
// For each of the first `cap` records writes spans[3k .. 3k+2] = the
// body's [start, end) and its count of canonical nucleotides.  Returns
// how many records the file holds (more than `cap`: call again with
// room), or a FASTA_* code where pfasta rejects the file.
i64 phy_fasta_layout(const u8 *src, i64 n, i64 *spans, i64 cap) {
    if (n == 0) return FASTA_EMPTY;
    if (src[0] != '>') return FASTA_NO_START;
    i64 records = 0;
    for (i64 at = 0; at < n; records++) {
        const i64 h0 = at + 1;
        const u8 *eol = (const u8 *)std::memchr(src + h0, '\n', n - h0);
        const i64 h1 = eol ? eol - src : n;
        if (!fasta_has_word(src + h0, h1 - h0)) return FASTA_EMPTY_NAME;
        // the body: up to a '>' right after a '\n' (the header's own
        // '\n' included: src[b0 - 1] is it)
        const i64 b0 = eol ? h1 + 1 : n;
        i64 b1 = n;
        for (i64 p = b0; p < n;) {
            const u8 *gt = (const u8 *)std::memchr(src + p, '>', n - p);
            if (gt == nullptr) break;
            if (gt[-1] == '\n') {
                b1 = gt - src;
                break;
            }
            p = gt - src + 1;
        }
        const i64 kept = count_nucl(src + b0, b1 - b0);
        if (kept == 0 && !fasta_has_word(src + b0, b1 - b0))
            return FASTA_EMPTY_SEQUENCE;
        if (records < cap) {
            i64 *s = spans + 3 * records;
            s[0] = b0, s[1] = b1, s[2] = kept;
        }
        at = b1;
    }
    return records;
}

// Lands the records phy_fasta_layout laid out: each body's canonical
// nucleotides, uppercased, the records joined by '!', into dst, which
// holds exactly their sum plus records - 1 bytes.
void phy_fasta_land(const u8 *src, const i64 *spans, i64 records, u8 *dst) {
    i64 w = 0;
    for (i64 k = 0; k < records; k++) {
        const i64 *s = spans + 3 * k;
        if (k) dst[w++] = '!';
        w += filter_nucl(src + s[0], s[1] - s[0], dst + w);
    }
}

// Scalar mismatch kernels (host oracle / benchmarking):
i64 phy_seqcmp(const u8 *a, const u8 *b, i64 len) {
    i64 cnt = 0;
    for (i64 t = 0; t < len; t++) cnt += a[t] != b[t];
    return cnt;
}

i64 phy_revseqcmp(const u8 *begin, const u8 *other, i64 len) {
    i64 cnt = 0;
    for (i64 t = 0; t < len; t++)
        cnt += ((begin[t] ^ other[len - 1 - t]) & 6) != 4;
    return cnt;
}

void phy_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

int phy_num_procs() {
#ifdef _OPENMP
    return omp_get_num_procs();
#else
    return 1;
#endif
}

int phy_version() { return 1; }

}  // extern "C"
