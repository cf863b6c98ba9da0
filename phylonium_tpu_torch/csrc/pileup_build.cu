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
// and columns at or past ref_len INVALID. Records are the host's
// pileup_prep.prep_intervals output: start-sorted and disjoint per row,
// padded with (ref_len, ref_len, ref_len, 0), which covers no column.
//
// The TPU program fetched 16 columns at a time through two 32-bit window
// gathers, because a per-column gather was its cost, and so needed the host
// overlay for every column where that window is inexact. Here each column
// is fetched exactly; the overlay is still applied in full, because '!'
// separators have no 2-bit code and a non-ACGT byte's packed code may differ
// from the host's code table, and the JAX program takes the overlay's value
// there.
//
// What bounds it: one thread per output byte, so each thread resolves two
// columns, j and j + l2. Per column it binary-searches its row's records
// (log2 H dependent loads, mostly L1/L2 hits shared by the warp) and its
// row's overlay entries (sorted by column on the host, per-row offsets), then
// reads one 32-bit word of codes; a warp's 32 stores are 32 consecutive
// bytes. The searches' dependent loads, not the 2-bit reads or the byte
// stores, set its time. Sorting the overlay on the host makes the byte
// that two entries (c and c + l2) share a read, not a racing scatter: no
// atomics, and the result is deterministic. Staging a tile's records in
// shared memory and wider stores are later work.
//
// Positions are 64-bit, as the host's records are; the host still refuses
// a group whose query bases reach 2^31, as the JAX package does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kInvalid = 10;
constexpr uint32_t kNBase = 5;
constexpr uint8_t kInvalidPair = kInvalid | (kInvalid << 4);
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ uint32_t column_state(
    int64_t col, int64_t ref_len,
    const int64_t* __restrict__ records, int64_t n_records,
    const uint32_t* __restrict__ words, int64_t n_codes,
    const int32_t* __restrict__ ocol, const uint8_t* __restrict__ oval,
    int64_t o_lo, int64_t o_hi) {
  if (col >= ref_len) return kInvalid;
  // the overlay wins wherever it has an entry (the JAX program scatters it
  // over the built rows); entries of one (row, col) repeat only with one value
  int64_t lo = o_lo, hi = o_hi;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ocol[mid] < col) lo = mid + 1; else hi = mid;
  }
  if (lo < o_hi && ocol[lo] == col) return oval[lo];
  // k = the number of records with start <= col; record k - 1 is the only
  // one that can cover col
  lo = 0;
  hi = n_records;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (records[4 * mid] <= col) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return kInvalid;
  const int64_t* rec = records + 4 * (lo - 1);
  if (col >= rec[1]) return kInvalid;
  const int64_t dir = rec[3];
  int64_t q = dir == 1 ? rec[2] - col : rec[2] + col;
  // the JAX program clamps its index the same way; a covered column of a
  // well-formed record never needs it
  q = q < 0 ? 0 : (q >= n_codes ? n_codes - 1 : q);
  const uint32_t code = (words[q >> 4] >> (2 * (q & 15))) & 3u;
  return code + kNBase * static_cast<uint32_t>(dir);
}

__global__ void __launch_bounds__(kThreads)
pileup_build_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                    const int64_t* __restrict__ records, int64_t rows,
                    int64_t n_records,
                    const int64_t* __restrict__ o_offsets,
                    const int32_t* __restrict__ ocol,
                    const uint8_t* __restrict__ oval,
                    int64_t ref_len, int64_t l2, int64_t width,
                    uint8_t* __restrict__ out, int64_t stride) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= width) return;
  const int64_t n_codes = 16 * n_words;
  for (int64_t g = blockIdx.y; g < rows; g += gridDim.y) {
    uint8_t byte = kInvalidPair;
    if (j < l2) {
      const int64_t* row_records = records + g * n_records * 4;
      const int64_t o_lo = o_offsets[g];
      const int64_t o_hi = o_offsets[g + 1];
      const uint32_t low = column_state(j, ref_len, row_records, n_records,
                                        words, n_codes, ocol, oval, o_lo, o_hi);
      const uint32_t high = column_state(j + l2, ref_len, row_records,
                                         n_records, words, n_codes, ocol,
                                         oval, o_lo, o_hi);
      byte = static_cast<uint8_t>(low | (high << 4));
    }
    out[g * stride + j] = byte;
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
  const int64_t blocks_x = (width + kThreads - 1) / kThreads;
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
