// Pileup rows from 2-bit query codes: the device half of the streamed feeder.
//
// This kernel replaces the XLA program of the JAX package,
// phylonium_tpu/ops/pileup_device.py::_build_packed (core
// _build_core_nosep). Both build one group's pileup rows and emit them in
// the counting kernel's split-nibble layout:
//
//     state[g, r] = code(q) + 5 * dir     if column r lies in record k of
//                                         row g: start_k <= r < end_k,
//                                         q = B_k + r (forward) or
//                                         B_k - r (reverse)
//                 = INVALID               otherwise
//     state[g, c] = val                   for every overlay entry (g, c, val)
//     out[g, j]   = state[g, j] | state[g, j + l2] << 4    for j < l2
//     out[g, j]   = INVALID | INVALID << 4                 for l2 <= j < W
//
// with l2 = ceil(ref_len / 2), code(q) = (words[q >> 4] >> 2 (q & 15)) & 3,
// q clamped into [0, 16 n_words) as the JAX program clamps it, and columns
// at or past ref_len INVALID. Records are the host's
// pileup_prep.prep_intervals output: start-sorted and disjoint per row,
// dir 0 (forward) or 1 (reverse), padded with (ref_len, ref_len, ref_len,
// 0), which covers no column; the record that can cover column r is the
// last one with start <= r. The overlay wins: '!' separators have no 2-bit
// code and a non-ACGT byte's packed code may differ from the host's code
// table, and the JAX program takes the overlay's value there.
//
// What bounds it on the H100: the bytes are few (a group's codes, records
// and overlay read once, its rows written once: 0.03-0.04 ms at the main
// path's groups), so the least time is a memory pass. An earlier design
// (one thread an output byte, two binary searches of the row's records and
// overlay in global memory for each of its two columns, a 4-byte code read
// a column, a 1-byte store) spent about 50 dependent loads on one byte,
// repeated by every thread of a record: instructions and load latency, not
// bytes, set its time, 100x its bound.
//
// The design: a block makes one tile of kTile = 4,096 output bytes of one
// row, and each thread 16 of them, written with one 16-byte store. The
// tile's low nibbles are the column span [j0, j0 + kTile) and its high
// nibbles [j0 + l2, j0 + l2 + kTile). Eight warps search at once, one
// bound each: for both spans the records that can cover them (a 32-way
// search, 32 probes a round, three rounds for 1,536 records) and the
// overlay's lower and upper bounds in the row's sorted columns. The block
// stages those records and entries in shared memory, in the span's own
// coordinates (columns counted from its start and clamped to the tile, so
// threads compare in 32 bits), kRecChunk records and kOverlayChunk entries
// a span at a time, and loops over such chunks when a span holds more
// (1-column records, dense overlays). Each thread then finds its 16
// columns' records in shared memory and fetches their codes a record at a
// time: 16 consecutive columns of one record are 16 consecutive 2-bit
// codes, one funnel shift of two 32-bit words, bit-reversed and pair-
// swapped for a reverse record, then spread to 16 bytes. Only where a
// code index would need the clamp does it fall back to one gather a
// column. Overlay entries of its window go to registers beside a mask, and
// win at the end whatever the chunk order; entries of one (row, col) carry
// one value, so no atomics are needed and the result is deterministic. A
// window is two named 8-byte halves, never an array indexed by column,
// which would put it in local memory.
//
// What holds it back now: the instruction rate. Per 16-byte window a
// thread spends a few hundred instructions (two binary searches in shared
// memory, a record's code fetch and spread, the overlay, the INVALID
// masks), about one warp instruction an output byte; the searches and
// staging without that per-thread work take a quarter of the time.
// Windows of 32 or 64 bytes a thread would spread that cost over more
// bytes.
//
// Positions are 64-bit, as the host's records are; the host still refuses
// a group whose query bases reach 2^31, as the JAX package does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 16;
constexpr int64_t kTile = kThreads * kBytesPerThread;
constexpr int kRecChunk = 128;      // records of one span staged at a time
constexpr int kOverlayChunk = 512;  // overlay entries of one span at a time
// Six resident blocks an SM, so ptxas fits the kernel in 40 registers.
// Left free it takes 110, two blocks an SM, and runs 1.65x slower on an
// H100 at the main path's groups.
constexpr int kMinBlocks = 6;
constexpr uint32_t kInvalid = 10;
constexpr uint32_t kNBase = 5;
constexpr uint32_t kInvalidBytes = kInvalid * 0x01010101u;
constexpr uint32_t kInvalidPairs = (kInvalid | (kInvalid << 4)) * 0x01010101u;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kNoStart = INT64_MAX;

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) {
  return x > y ? x : y;
}
__device__ __forceinline__ int32_t local(int64_t col, int64_t lo) {
  return static_cast<int32_t>(min64(max64(col - lo, 0), kTile));
}

// The first index u in [lo, hi] with key(u) > x, keys ascending over
// [lo, hi): key(i) = keys[i * stride]. One warp, every lane gets u. Each
// round probes the last key of 32 equal pieces and keeps the piece where
// the keys pass x.
template <typename Key>
__device__ int64_t warp_upper_bound(const Key* __restrict__ keys, int stride,
                                    int64_t lo, int64_t hi, int64_t x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && static_cast<int64_t>(keys[p * stride]) <= x;
    const int n = __popc(__ballot_sync(0xffffffffu, le));
    hi = min64(hi, lo + (n + 1) * step - 1);  // the first probe past x
    lo += n * step;
  }
  const int64_t p = lo + lane;
  const bool le = p < hi && static_cast<int64_t>(keys[p * stride]) <= x;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

// 4 bits -> 4 bytes of 0xff
__device__ __forceinline__ uint32_t byte_mask(uint32_t nibble) {
  return ((nibble * 0x00204081u) & 0x01010101u) * 0xffu;
}

// four 2-bit fields -> four bytes
__device__ __forceinline__ uint32_t spread(uint32_t fields) {
  return (fields & 0x3u) | ((fields & 0xcu) << 6) | ((fields & 0x30u) << 12) |
         ((fields & 0xc0u) << 18);
}

__device__ __forceinline__ uint32_t code_at(const uint32_t* __restrict__ words,
                                            int64_t q) {
  return (words[q >> 4] >> (2 * (q & 15))) & 3u;
}

// 16 bits -> 16 bytes of 0xff, as the two 8-byte halves of a window
__device__ __forceinline__ uint64_t byte_mask8(uint32_t bits) {
  return byte_mask(bits & 0xfu) |
         static_cast<uint64_t>(byte_mask((bits >> 4) & 0xfu)) << 32;
}

// eight 2-bit fields -> eight bytes
__device__ __forceinline__ uint64_t spread8(uint32_t fields) {
  return spread(fields & 0xffu) |
         static_cast<uint64_t>(spread((fields >> 8) & 0xffu)) << 32;
}

// Set byte k of a 16-byte window held in two 8-byte halves. Named halves,
// not an array: an array indexed by k would live in local memory.
__device__ __forceinline__ void set_byte(uint64_t& lo, uint64_t& hi, int k,
                                         uint32_t byte) {
  const int sh = 8 * (k & 7);
  const uint64_t keep = ~(0xffull << sh);
  const uint64_t put = static_cast<uint64_t>(byte) << sh;
  if (k < 8) lo = (lo & keep) | put; else hi = (hi & keep) | put;
}

// A record as the threads of one span read it, columns counted from the
// span's first column and clamped into [0, kTile], where every thread's
// window lies, so that 32-bit compares decide as the 64-bit ones would.
struct SpanRecord {
  int64_t first;  // code index of the span's first column: B + lo, or B - lo
  int32_t start;  // its first column
  int32_t stop;   // the end of what it covers: min(end, the next start)
  uint32_t dir;
};

// One round of a span's records and overlay entries, staged.
struct Chunk {
  SpanRecord rec[kRecChunk];
  int32_t col[kOverlayChunk];  // overlay columns, from the span's first
  uint8_t val[kOverlayChunk];
};

// Where one span's records and overlay entries lie in the row's arrays,
// from the searches' bounds (bound[0], bound[1]: records; bound[4],
// bound[5]: overlay entries): records [rec_first, rec_first + rec_count),
// entries [ovl_first, ovl_first + ovl_count).
struct Span {
  int64_t rec_first, rec_count, ovl_first, ovl_count;

  __device__ __forceinline__ explicit Span(const int64_t* bound) {
    rec_first = max64(bound[0] - 1, 0);
    rec_count = max64(bound[1] - rec_first, 0);
    ovl_first = bound[4];
    ovl_count = bound[5] - ovl_first;
  }
  __device__ __forceinline__ int64_t rounds() const {
    return max64((rec_count + kRecChunk - 1) / kRecChunk,
                 (ovl_count + kOverlayChunk - 1) / kOverlayChunk);
  }
  __device__ __forceinline__ int records_in(int64_t round) const {
    return static_cast<int>(
        max64(min64(rec_count - round * kRecChunk, kRecChunk), 0));
  }
  __device__ __forceinline__ int entries_in(int64_t round) const {
    return static_cast<int>(
        max64(min64(ovl_count - round * kOverlayChunk, kOverlayChunk), 0));
  }
};

// The block copies round `round` of the span starting at column `lo` into
// shared memory, in the span's own coordinates.
__device__ __forceinline__ void stage(
    Chunk& chunk, const Span& span, int64_t round, int64_t lo,
    const int64_t* __restrict__ row_records, int64_t n_records,
    const int32_t* __restrict__ ocol, const uint8_t* __restrict__ oval) {
  const int64_t r0 = span.rec_first + round * kRecChunk;
  const int n_rec = span.records_in(round);
  for (int i = threadIdx.x; i < n_rec; i += kThreads) {
    const int64_t* r = row_records + (r0 + i) * 4;
    const int64_t next = r0 + i + 1 < n_records ? r[4] : kNoStart;
    SpanRecord& out = chunk.rec[i];
    out.first = r[3] == 1 ? r[2] - lo : r[2] + lo;
    out.start = local(r[0], lo);
    out.stop = local(min64(r[1], next), lo);
    out.dir = static_cast<uint32_t>(r[3]);
  }
  const int64_t e0 = span.ovl_first + round * kOverlayChunk;
  const int n_ovl = span.entries_in(round);
  for (int i = threadIdx.x; i < n_ovl; i += kThreads) {
    chunk.col[i] = static_cast<int32_t>(ocol[e0 + i] - lo);
    chunk.val[i] = oval[e0 + i];
  }
}

// One thread's 16 columns [c0, c0 + 16) of one span, c0 counted from the
// span's first column; byte k of a window is column c0 + k.
struct Window {
  uint64_t rec_lo, rec_hi;  // the records' states, INVALID where none covers
  uint64_t ovl_lo, ovl_hi;  // the overlay's states where `mask` has the column
  uint32_t mask;

  __device__ __forceinline__ void init() {
    rec_lo = rec_hi = kInvalidBytes * 0x0000000100000001ull;
    ovl_lo = ovl_hi = 0;
    mask = 0;
  }

  // Columns [c0 + lo, c0 + hi) take record r's states.
  __device__ __forceinline__ void apply(const SpanRecord& r, int c0, int lo,
                                        int hi,
                                        const uint32_t* __restrict__ words,
                                        int64_t n_codes) {
    const bool rev = r.dir == 1;
    // the code index of column c0 + k is first + k (forward) or first - k
    const int64_t first = rev ? r.first - c0 : r.first + c0;
    const int64_t q_lo = rev ? first - 15 : first;
    if (q_lo >= 0 && q_lo + 15 < n_codes) {
      // the 16 codes q_lo .. q_lo + 15, code q_lo + i at bits 2i
      const int64_t w = q_lo >> 4;
      const uint32_t w0 = words[w];
      const uint32_t w1 = words[min64(w + 1, (n_codes >> 4) - 1)];
      uint32_t fields =
          __funnelshift_r(w0, w1, 2 * static_cast<unsigned>(q_lo & 15));
      if (rev) {
        // field i -> field 15 - i: reverse the bits, then swap each pair back
        fields = __brev(fields);
        fields = ((fields >> 1) & 0x55555555u) | ((fields & 0x55555555u) << 1);
      }
      const uint64_t add = kNBase * r.dir * 0x0101010101010101ull;
      const uint32_t keep = ((1u << hi) - 1) & ~((1u << lo) - 1);
      const uint64_t sel_lo = byte_mask8(keep), sel_hi = byte_mask8(keep >> 8);
      rec_lo = (rec_lo & ~sel_lo) | ((spread8(fields) + add) & sel_lo);
      rec_hi = (rec_hi & ~sel_hi) | ((spread8(fields >> 16) + add) & sel_hi);
    } else {
      // a code index outside [0, n_codes): one clamped gather a column
#pragma unroll 1
      for (int k = lo; k < hi; ++k) {
        int64_t q = rev ? first - k : first + k;
        q = q < 0 ? 0 : (q >= n_codes ? n_codes - 1 : q);
        set_byte(rec_lo, rec_hi, k, code_at(words, q) + kNBase * r.dir);
      }
    }
  }

  // The records of one chunk that govern columns of the window: the last
  // one starting at or before a column governs it and covers it below its
  // stop.
  __device__ __forceinline__ void apply_records(
      const Chunk& chunk, int n, int c0, const uint32_t* __restrict__ words,
      int64_t n_codes) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk.rec[mid].start <= c0) lo = mid + 1; else hi = mid;
    }
    for (int i = lo > 0 ? lo - 1 : 0; i < n; ++i) {
      const SpanRecord r = chunk.rec[i];
      if (r.start >= c0 + 16) break;
      const int from = max(r.start, c0);
      const int to = min(r.stop, c0 + 16);
      if (to > from) apply(r, c0, from - c0, to - c0, words, n_codes);
    }
  }

  __device__ __forceinline__ void apply_overlay(const Chunk& chunk, int n,
                                                int c0) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk.col[mid] < c0) lo = mid + 1; else hi = mid;
    }
    for (int i = lo; i < n && chunk.col[i] < c0 + 16; ++i) {
      const int k = chunk.col[i] - c0;
      set_byte(ovl_lo, ovl_hi, k, chunk.val[i]);
      mask |= 1u << k;
    }
  }

  // The states, overlay over records, INVALID from the window's column
  // `valid` on; as the two 8-byte halves.
  __device__ __forceinline__ void finish(int64_t valid, uint64_t& lo,
                                         uint64_t& hi) const {
    const uint32_t bits =
        valid >= 16 ? 0xffffu : (valid <= 0 ? 0u : (1u << valid) - 1);
    const uint64_t invalid = kInvalidBytes * 0x0000000100000001ull;
    const uint64_t sel_lo = byte_mask8(mask), sel_hi = byte_mask8(mask >> 8);
    const uint64_t in_lo = byte_mask8(bits), in_hi = byte_mask8(bits >> 8);
    lo = (rec_lo & ~sel_lo) | (ovl_lo & sel_lo);
    hi = (rec_hi & ~sel_hi) | (ovl_hi & sel_hi);
    lo = (lo & in_lo) | (invalid & ~in_lo);
    hi = (hi & in_hi) | (invalid & ~in_hi);
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
pileup_build_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                    const int64_t* __restrict__ records, int64_t rows,
                    int64_t n_records,
                    const int64_t* __restrict__ o_offsets,
                    const int32_t* __restrict__ ocol,
                    const uint8_t* __restrict__ oval,
                    int64_t ref_len, int64_t l2, int64_t width,
                    uint8_t* __restrict__ out, int64_t stride) {
  __shared__ Chunk s_chunk[2];
  // the searches' bounds: records of span 0 and 1 (lower, upper), then
  // overlay entries of span 0 and 1
  __shared__ int64_t s_bound[kWarps];

  const int warp = threadIdx.x >> 5;
  const int64_t n_codes = 16 * n_words;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int c0 = kBytesPerThread * threadIdx.x;  // from the span's start
  const int64_t j = j0 + c0;
  // span 0 (the low nibbles) covers columns [j0, low_end), span 1 (the
  // high ones) [j0 + l2, min(low_end + l2, ref_len))
  const int64_t low_end = min64(j0 + kTile, l2);

  for (int64_t g = blockIdx.y; g < rows; g += gridDim.y) {
    const int64_t* row_records = records + g * n_records * 4;

    // eight bounds at once, one a warp: warps 0-3 the records that can
    // cover span 0 and 1 (the last one starting at or before the span's
    // first column, through the last one starting before its end), warps
    // 4-7 the overlay entries inside each span
    {
      const bool high = warp & 2;
      const bool upper = warp & 1;
      const int64_t lo = high ? j0 + l2 : j0;
      const int64_t hi = high ? min64(low_end + l2, ref_len) : low_end;
      int64_t bound = 0;
      if (hi > lo) {
        if (warp < 4)
          bound = warp_upper_bound(row_records, 4, 0, n_records,
                                   upper ? hi - 1 : lo);
        else
          bound = warp_upper_bound(ocol, 1, o_offsets[g], o_offsets[g + 1],
                                   (upper ? hi : lo) - 1);
      }
      if ((threadIdx.x & 31) == 0) s_bound[warp] = bound;
    }
    __syncthreads();

    Window low, high;  // span 0 and span 1
    low.init();
    high.init();
    const int64_t rounds =
        max64(Span(s_bound).rounds(), Span(s_bound + 2).rounds());
    for (int64_t round = 0; round < rounds; ++round) {
      if (round > 0) __syncthreads();  // the last round's chunks are read
#pragma unroll
      for (int s = 0; s < 2; ++s)
        stage(s_chunk[s], Span(s_bound + 2 * s), round, s ? j0 + l2 : j0,
              row_records, n_records, ocol, oval);
      __syncthreads();
      if (j < l2) {
        const Span span0(s_bound), span1(s_bound + 2);
        low.apply_records(s_chunk[0], span0.records_in(round), c0, words,
                          n_codes);
        low.apply_overlay(s_chunk[0], span0.entries_in(round), c0);
        high.apply_records(s_chunk[1], span1.records_in(round), c0, words,
                           n_codes);
        high.apply_overlay(s_chunk[1], span1.entries_in(round), c0);
      }
    }

    if (j < width) {
      const uint64_t pairs = kInvalidPairs * 0x0000000100000001ull;
      uint64_t v_lo = pairs, v_hi = pairs;
      if (j < l2) {
        uint64_t low_lo, low_hi, high_lo, high_hi;
        low.finish(l2 - j, low_lo, low_hi);
        high.finish(ref_len - l2 - j, high_lo, high_hi);
        v_lo = low_lo | (high_lo << 4);
        v_hi = low_hi | (high_hi << 4);
      }
      uint8_t* dst = out + g * stride + j;
      if (j + kBytesPerThread <= width &&
          (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(v_lo, v_hi);
      } else {
#pragma unroll
        for (int k = 0; k < kBytesPerThread; ++k)
          if (j + k < width)
            dst[k] = static_cast<uint8_t>((k < 8 ? v_lo : v_hi) >>
                                          (8 * (k & 7)));
      }
    }
    __syncthreads();  // s_bound and the chunks are free for the next row
  }
}

}  // namespace

// words: uint32 [n_words] 2-bit codes, code q at bits 2 (q & 15) of word
// q >> 4 (n_words >= 1). records: int64 [rows, n_records, 4] (start, end,
// B, dir). o_offsets: int64 [rows + 1]; row g's overlay entries are
// ocol/oval[o_offsets[g] : o_offsets[g + 1]], sorted by column. out: rows
// of `width` bytes, `stride` bytes apart; every byte written. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int pt_pileup_build(const int32_t* words, int64_t n_words,
                               const int64_t* records, int64_t rows,
                               int64_t n_records, const int64_t* o_offsets,
                               const int32_t* ocol, const uint8_t* oval,
                               int64_t ref_len, int64_t width, uint8_t* out,
                               int64_t stride, void* stream) {
  const int64_t l2 = (ref_len + 1) / 2;
  if (n_words < 1 || rows < 0 || n_records < 1 || ref_len < 1 ||
      width < l2 || stride < width)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t blocks_x = (width + kTile - 1) / kTile;
  if (blocks_x > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t blocks_y = rows < kMaxGridY ? rows : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(blocks_y));
  pileup_build_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(words), n_words, records, rows,
      n_records, o_offsets, ocol, oval, ref_len, l2, width, out, stride);
  return cudaGetLastError();
}
