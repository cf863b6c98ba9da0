// Diagonal mismatch bitmaps: the device half of hybrid anchor mapping.
//
// This kernel replaces the Pallas kernel of the JAX package,
// phylonium_tpu/ops/anchor_extend_pallas.py::_diagonal_neq_pallas (body
// _kernel), and the XLA op it stands in for,
// phylonium_tpu/ops/anchor_extend.py::_diagonal_neq. Both compute, for job
// j < B and position i < length,
//
//     neq[j, i] = a[off_a[j] + i] != b[off_b[j] + i]
//                 || off_a[j] + i >= lim_a[j] || off_b[j] + i >= lim_b[j]
//
// and so does this kernel. Each row is written as packed 32-bit words:
// bit i % 32 of word i / 32 is position i; bits past `length` are 0.
//
// What bounds it: moving bytes. A call reads 2*B*length text bytes (most
// from L2: the hybrid mapper's texts are tens of MB) and writes B*length/8,
// with a compare and a ballot per byte pair, so memory traffic and the
// rate of load instructions set its time together. The design keeps the work
// per byte small: one lane per byte, so a warp's loads are 32 consecutive
// bytes of each text, and `__ballot_sync` turns the 32 compares into the
// word that lane 0 stores. Loads are predicated on both limits and both text
// lengths, so texts need no sentinel padding and a request that starts past
// a text's end reads nothing. Positions are 64-bit: an offset near 2^31 plus
// i overflows int32.
//
// The Pallas kernel's roll-and-one-hot-row accumulation and its int32
// output exist for Mosaic's limits (no i8 vectors, 32-bit roll only) and
// are not carried over. Wider loads (16 bytes a lane, realigned with
// funnel shifts) are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = 8;   // words a warp makes per job, on average
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__global__ void __launch_bounds__(kThreads)
diagonal_neq_kernel(const uint8_t* __restrict__ a, int64_t a_len,
                    const uint8_t* __restrict__ b, int64_t b_len,
                    const int64_t* __restrict__ off_a,
                    const int64_t* __restrict__ off_b,
                    const int64_t* __restrict__ lim_a,
                    const int64_t* __restrict__ lim_b, int64_t jobs,
                    int64_t length, int64_t words,
                    uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t first_word =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t word_step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t j = blockIdx.y; j < jobs; j += gridDim.y) {
    const int64_t oa = off_a[j];
    const int64_t ob = off_b[j];
    // positions i < valid read a byte of both texts; every later one is
    // past a limit or a text end and is a mismatch (valid may be < 0)
    const int64_t valid = min64(min64(lim_a[j], a_len) - oa,
                                min64(lim_b[j], b_len) - ob);
    const int64_t end = min64(valid, length);
    uint32_t* row = out + j * words;
    // the loop bound is the same for every lane of a warp, so all 32
    // lanes reach the ballot together
    for (int64_t w = first_word; w < words; w += word_step) {
      const int64_t i = w * 32 + lane;
      bool neq = i < length;
      if (i < end) neq = a[oa + i] != b[ob + i];
      const uint32_t bits = __ballot_sync(0xffffffffu, neq);
      if (lane == 0) row[w] = bits;
    }
  }
}

}  // namespace

// a, b: uint8 texts of a_len and b_len bytes. off_a, off_b, lim_a,
// lim_b: int64 [jobs] on the device; offsets >= 0. out_words: int32
// [jobs, ceil(length / 32)], every word written. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int pt_diagonal_neq(const uint8_t* a, int64_t a_len,
                               const uint8_t* b, int64_t b_len,
                               const int64_t* off_a, const int64_t* off_b,
                               const int64_t* lim_a, const int64_t* lim_b,
                               int64_t jobs, int64_t length,
                               int32_t* out_words, void* stream) {
  if (a_len < 0 || b_len < 0 || jobs < 0 || length < 0)
    return cudaErrorInvalidValue;
  const int64_t words = (length + 31) / 32;
  if (jobs == 0 || words == 0) return cudaSuccess;
  const int64_t per_block = static_cast<int64_t>(kWarps) * kWordsPerWarp;
  int64_t blocks_x = (words + per_block - 1) / per_block;
  if (blocks_x > 65535) blocks_x = 65535;
  const int64_t blocks_y = jobs < kMaxGridY ? jobs : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(blocks_y));
  diagonal_neq_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, a_len, b, b_len, off_a, off_b, lim_a, lim_b, jobs, length, words,
      reinterpret_cast<uint32_t*>(out_words));
  return cudaGetLastError();
}
