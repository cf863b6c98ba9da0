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
// What bounds it on the H100: a call reads 2*B*length text bytes (the
// hybrid mapper's texts are tens of MB, mostly served from L2) and writes
// B*length/8 bytes, with one compare a byte pair and nothing else, so the
// least time is the text bytes over the memory rate. What kept the first
// design (one lane a byte pair, a 1-byte load from each text, a compare
// and a __ballot_sync a position, lane 0 storing the word) far from that
// was the instruction rate: two load instructions for every 32 positions
// of a warp, and 31 of 32 lanes idle at each store.
//
// The design: one output word a lane, no ballot. Lane w of a job makes
// word w of its row, so a warp stores 32 consecutive words. Its 32 bytes
// of each text start at any alignment: the lane loads the aligned 16-byte
// words that cover them (three, or two when aligned) and realigns them in
// registers, a shift by whole words (selects) and a funnel shift by the
// remaining bytes. __vcmpne4 compares four byte pairs at once, and a
// multiply gathers its four flags into four bits of the word. A word whose
// positions run past `end` = min(valid, length), or whose covering 16-byte
// words reach outside a text, takes the byte path: one predicated 1-byte
// load a text and position, so no load ever touches a byte outside
// [0, a_len) or [0, b_len) and texts need no sentinel padding. Positions
// at or past `end` are mismatches by mask; bits at or past `length` are
// 0. Positions are 64-bit: an offset near 2^31 plus i overflows int32.
//
// What holds it back now, on an H100: where jobs overlap (the anchor-
// extension micro's 128 jobs read each byte of a 10 MB text about 6.7
// times), the text reads are served by L2 at about 4 TB/s, a quarter of
// the bound that counts each byte once; a hybrid mapping round (8 jobs,
// half a wave of blocks) takes about two bound-times, close to one
// launch's latency.
//
// The Pallas kernel's roll-and-one-hot-row accumulation and its int32
// output exist for Mosaic's limits (no i8 vectors, 32-bit roll only) and
// are not carried over.
//
// The second entry, pt_diagonal_neq_shard, replaces the shard step of
// phylonium_tpu/ops/anchor_extend_sharded.py::_diag_neq_sharded (X5): the
// index text split into contiguous shards, each with a right halo that it
// reads but does not own. The JAX op owns `tile`-byte rounds and merges
// the shards with a psum; here the unit of ownership is one output word,
// and the merge is an OR of the shards' rows (ops/anchor_extend_sharded.py).
// It is the same kernel: a call that owns every word is K3. Its bound is
// K3's for the same jobs plus the merge, (S - 1) rows of words per job.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridX = 65535;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// the 12 little-endian words of the three aligned 16-byte loads that
// cover p[0, 32); the third only when p is not 16-byte aligned
__device__ __forceinline__ void load_cover(const uint8_t* p,
                                           uint32_t (&w)[12]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(addr & ~uintptr_t{15});
  const uint4 x0 = q[0];
  const uint4 x1 = q[1];
  const uint4 x2 = (addr & 15) ? q[2] : make_uint4(0, 0, 0, 0);
  w[0] = x0.x; w[1] = x0.y; w[2] = x0.z;  w[3] = x0.w;
  w[4] = x1.x; w[5] = x1.y; w[6] = x1.z;  w[7] = x1.w;
  w[8] = x2.x; w[9] = x2.y; w[10] = x2.z; w[11] = x2.w;
}

// p[4k, 4k + 4) as little-endian words, k < 8, from load_cover's words
__device__ __forceinline__ void realign(const uint8_t* p,
                                        const uint32_t (&w)[12],
                                        uint32_t (&out)[8]) {
  const unsigned r = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 15);
  const bool by2 = r & 8;
  const bool by1 = r & 4;
  uint32_t e[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) e[k] = by2 ? w[k + 2] : w[k];
  uint32_t f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = by1 ? e[k + 1] : e[k];
  const unsigned shift = 8 * (r & 3);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = __funnelshift_r(f[k], f[k + 1], shift);
}

// the 16-byte words covering p[0, 32) lie inside [text, text + len)
__device__ __forceinline__ bool cover_inside(const uint8_t* p,
                                             const uint8_t* text,
                                             int64_t len) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = addr & ~uintptr_t{15};
  const uintptr_t hi = lo + ((addr & 15) ? 48 : 32);
  const uintptr_t t = reinterpret_cast<uintptr_t>(text);
  return lo >= t && hi <= t + static_cast<uintptr_t>(len);
}

// bit k set where pa[k] != pb[k], k < 32, from wide loads
__device__ __forceinline__ uint32_t neq_word(const uint8_t* pa,
                                             const uint8_t* pb) {
  uint32_t wa[12], wb[12], xa[8], xb[8];
  load_cover(pa, wa);
  load_cover(pb, wb);
  realign(pa, wa, xa);
  realign(pb, wb, xb);
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // 0x01 in each byte that differs; the multiply moves byte m's flag to
    // bit 28 + m and the shift brings the four down (no carries collide)
    const uint32_t flags = __vcmpne4(xa[k], xb[k]) & 0x01010101u;
    bits |= ((flags * 0x10204080u) >> 28) << (4 * k);
  }
  return bits;
}

// One kernel serves K3 and X5's shard step. `a` holds the global text
// positions [base, base + a_len) of the index text: all of it for K3
// (base 0), one shard and its right halo for X5. A word of a job's row is
// computed only by the call that owns it, the call whose range
// [base, own_end) holds the global position of the word's first byte,
// off_a[j] + 32 w; every other word is written 0. The owner applies the
// limits, so ORing the rows of calls whose ranges partition [0, inf) gives
// the row of one unsharded call, bit for bit. An owned word reads at most
// 31 bytes past own_end, which the caller's halo covers; reads are bounded
// by the buffer in any case, and positions past it are mismatches.
__global__ void __launch_bounds__(kThreads)
diagonal_neq_kernel(const uint8_t* __restrict__ a, int64_t base,
                    int64_t a_len, int64_t own_end,
                    const uint8_t* __restrict__ b, int64_t b_len,
                    const int64_t* __restrict__ off_a,
                    const int64_t* __restrict__ off_b,
                    const int64_t* __restrict__ lim_a,
                    const int64_t* __restrict__ lim_b, int64_t jobs,
                    int64_t length, int64_t words,
                    uint32_t* __restrict__ out) {
  const int64_t first_word =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t word_step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = blockIdx.y; j < jobs; j += gridDim.y) {
    const int64_t oa = off_a[j];
    const int64_t ob = off_b[j];
    // positions i < valid read a byte of both texts; every later one is
    // past a limit or a text end and is a mismatch (valid may be < 0)
    const int64_t valid = min64(min64(lim_a[j], base + a_len) - oa,
                                min64(lim_b[j], b_len) - ob);
    const int64_t end = min64(valid, length);
    // this job's diagonal in the buffer's coordinates
    const int64_t la = oa - base;
    uint32_t* row = out + j * words;
    for (int64_t w = first_word; w < words; w += word_step) {
      const int64_t i0 = w * 32;
      if (oa + i0 < base || oa + i0 >= own_end) {
        row[w] = 0;  // another call's word
        continue;
      }
      // positions of this word that read the texts, and that lie in the row
      const int64_t n_read = end - i0 < 0 ? 0 : min64(end - i0, 32);
      const int64_t n_row = min64(length - i0, 32);
      uint32_t bits = 0;
      if (n_read == 32 && cover_inside(a + la + i0, a, a_len) &&
          cover_inside(b + ob + i0, b, b_len)) {
        bits = neq_word(a + la + i0, b + ob + i0);
      } else {
        for (int k = 0; k < n_read; ++k)
          bits |= static_cast<uint32_t>(a[la + i0 + k] != b[ob + i0 + k]) << k;
      }
      const uint32_t read_mask = n_read == 32 ? ~0u : (1u << n_read) - 1;
      const uint32_t row_mask = n_row == 32 ? ~0u : (1u << n_row) - 1;
      row[w] = (bits & read_mask) | (~read_mask & row_mask);
    }
  }
}

int launch(const uint8_t* a, int64_t base, int64_t a_len, int64_t own_end,
           const uint8_t* b, int64_t b_len, const int64_t* off_a,
           const int64_t* off_b, const int64_t* lim_a, const int64_t* lim_b,
           int64_t jobs, int64_t length, int32_t* out_words, void* stream) {
  if (a_len < 0 || b_len < 0 || jobs < 0 || length < 0 || base < 0 ||
      own_end < base)
    return cudaErrorInvalidValue;
  const int64_t words = (length + 31) / 32;
  if (jobs == 0 || words == 0) return cudaSuccess;
  int64_t blocks_x = (words + kThreads - 1) / kThreads;
  if (blocks_x > kMaxGridX) blocks_x = kMaxGridX;
  const int64_t blocks_y = jobs < kMaxGridY ? jobs : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(blocks_y));
  diagonal_neq_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, base, a_len, own_end, b, b_len, off_a, off_b, lim_a, lim_b, jobs,
      length, words, reinterpret_cast<uint32_t*>(out_words));
  return cudaGetLastError();
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
  return launch(a, 0, a_len, INT64_MAX, b, b_len, off_a, off_b, lim_a, lim_b,
                jobs, length, out_words, stream);
}

// X5's shard step: `shard` holds global positions [base, base + shard_len)
// of the index text (a shard and its halo); the call owns the words whose
// first a-position lies in [base, own_end) and writes every other word 0.
// Offsets and limits are global. Otherwise as pt_diagonal_neq, which is
// this call with base 0 and own_end INT64_MAX.
extern "C" int pt_diagonal_neq_shard(const uint8_t* shard, int64_t shard_len,
                                     int64_t base, int64_t own_end,
                                     const uint8_t* b, int64_t b_len,
                                     const int64_t* off_a,
                                     const int64_t* off_b,
                                     const int64_t* lim_a,
                                     const int64_t* lim_b, int64_t jobs,
                                     int64_t length, int32_t* out_words,
                                     void* stream) {
  return launch(shard, base, shard_len, own_end, b, b_len, off_a, off_b,
                lim_a, lim_b, jobs, length, out_words, stream);
}
