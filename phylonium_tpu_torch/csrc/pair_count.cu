// All-pairs match and homolog counts over split-nibble packed pileup rows.
//
// This kernel replaces the two Pallas kernels of the JAX package,
// phylonium_tpu/ops/pallas_match.py::_count_kernel_packed (the square
// all-pairs block) and ::_cross_kernel_packed (the rectangular panels).
// Both compute one function, so one kernel serves both: a symmetric call
// (a == b) counts the upper-triangle tiles only.
//
// Input rows are uint8, each byte holding two pileup states (low nibble =
// column j, high nibble = column j + ceil(L/2); ops/shapes.py::pack_states).
// For every row pair (i, j) and every column:
//
//     matches[i, j] += MATCH_TABLE[sa, sb]      (bit sb of PARTNER_MASK[sa])
//     homs[i, j]    += (sa < 10) & (sb < 10)
//
// The padding byte 0xAA holds INVALID (10) twice: its mask is 0 and it is
// not valid, so padding rows and columns add nothing.
//
// What bounds it: integer ALU work. A call does N^2 * L/2 pair-columns
// against only N * L/2 bytes read, so the card's memory is idle and each
// pair-byte costs a few integer instructions (two shifts, two ands and an
// add on a packed 16+16-bit accumulator). The design keeps that loop free
// of lookups: each A byte is turned into two 32-bit words once per stage
// (partner mask in the low half, validity mask in the high half), so a
// pair needs only `word >> sb`. Faster designs are later work: bitplane
// popcount (ops/bitplane_host.py in the JAX package) or int8 mma into
// int32 on the tensor cores.
//
// Shape: each block owns a 64 x 64 output tile, 256 threads with 4 x 4
// pairs each, and walks its column range in 64-byte stages staged through
// shared memory. The TPU kernel carries its sums across a sequential grid;
// blocks on Hopper run in no order, so the grid's third dimension splits
// the columns and the splits atomicAdd into outputs that start zeroed.
// Integer adds are exact in any order, so results are bit-identical and
// deterministic. Splitting matters for small N: a 29-genome panel is one
// tile, and without it one SM would walk every column alone.
//
// int32 sums are exact while a cell counts fewer than 2^31 columns; the
// Python wrapper refuses wider inputs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // output rows and columns per block
constexpr int kStage = 64;      // packed bytes staged per step
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 pairs each
constexpr int kBlocksPerSm = 8; // column splits aim at this many blocks per SM
constexpr uint32_t kPackedPad = 0xAAAAAAAAu;
constexpr uint32_t kValidBits = 0x3FFu << 16;  // states 0..9 are valid
constexpr uint32_t kPairBits = 0x10001u;       // match bit | homolog bit

// bit t of entry s is set iff MATCH_TABLE[s, t]; entries 10..15 are 0.
// Uploaded by pt_set_partner_mask from the Python table.
__constant__ uint16_t PARTNER_MASK[16];

__global__ void __launch_bounds__(kThreads)
cross_counts_kernel(const uint8_t* __restrict__ a, int64_t lda, int na,
                    const uint8_t* __restrict__ b, int64_t ldb, int nb,
                    int64_t width, int64_t stages_per_split,
                    int32_t* __restrict__ matches,
                    int32_t* __restrict__ homs, int symmetric) {
  const int tile_i = blockIdx.y;
  const int tile_j = blockIdx.x;
  if (symmetric && tile_j < tile_i) return;

  // word_of[s]: partner mask of state s (low half) and, when s is valid,
  // the validity mask of states 0..9 (high half). For a pair (sa, sb),
  // (word_of[sa] >> sb) & kPairBits holds the match bit at 0 and the
  // homolog bit at 16.
  __shared__ uint32_t word_of[16];
  __shared__ __align__(16) uint32_t a_lo[kStage][kTile];
  __shared__ __align__(16) uint32_t a_hi[kStage][kTile];
  __shared__ __align__(16) uint8_t b_raw[kStage][kTile];

  const int tid = threadIdx.x;
  if (tid < 16) {
    word_of[tid] = PARTNER_MASK[tid] | (tid < 10 ? kValidBits : 0u);
  }

  const int i0 = tile_i * kTile;
  const int j0 = tile_j * kTile;
  // staging: thread -> (row of the tile, 16-byte segment of the stage)
  const int load_row = tid >> 2;
  const int load_seg = (tid & 3) * 16;
  // compute: thread -> rows 4*ty.., columns 4*tx..
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const int64_t total_stages = (width + kStage - 1) / kStage;
  const int64_t s_begin = blockIdx.z * stages_per_split;
  const int64_t s_end = s_begin + stages_per_split < total_stages
                            ? s_begin + stages_per_split
                            : total_stages;

  int32_t m_sum[4][4] = {};
  int32_t h_sum[4][4] = {};

  for (int64_t s = s_begin; s < s_end; ++s) {
    const int64_t col = s * kStage + load_seg;
    uint4 va = make_uint4(kPackedPad, kPackedPad, kPackedPad, kPackedPad);
    uint4 vb = va;
    if (col < width) {  // width is a multiple of 16: a segment is all in
      if (i0 + load_row < na)
        va = *reinterpret_cast<const uint4*>(a + (i0 + load_row) * lda + col);
      if (j0 + load_row < nb)
        vb = *reinterpret_cast<const uint4*>(b + (j0 + load_row) * ldb + col);
    }
    __syncthreads();  // the previous stage's readers are done
    const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
    const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t byte_a = (wa[e >> 2] >> (8 * (e & 3))) & 0xFFu;
      a_lo[load_seg + e][load_row] = word_of[byte_a & 15u];
      a_hi[load_seg + e][load_row] = word_of[byte_a >> 4];
      b_raw[load_seg + e][load_row] =
          static_cast<uint8_t>(wb[e >> 2] >> (8 * (e & 3)));
    }
    __syncthreads();

    // packed 16+16-bit sums: at most 2 * kStage per half per stage
    uint32_t acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < kStage; ++k) {
      const uint4 lo = *reinterpret_cast<const uint4*>(&a_lo[k][4 * ty]);
      const uint4 hi = *reinterpret_cast<const uint4*>(&a_hi[k][4 * ty]);
      const uint32_t bw = *reinterpret_cast<const uint32_t*>(&b_raw[k][4 * tx]);
      const uint32_t alo[4] = {lo.x, lo.y, lo.z, lo.w};
      const uint32_t ahi[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sb_lo = (bw >> (8 * c)) & 15u;
        const uint32_t sb_hi = (bw >> (8 * c + 4)) & 15u;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][c] += ((alo[r] >> sb_lo) & kPairBits) +
                       ((ahi[r] >> sb_hi) & kPairBits);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        m_sum[r][c] += acc[r][c] & 0xFFFFu;
        h_sum[r][c] += acc[r][c] >> 16;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= na) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      if (j >= nb) continue;
      const int64_t cell = static_cast<int64_t>(i) * nb + j;
      atomicAdd(matches + cell, m_sum[r][c]);
      atomicAdd(homs + cell, h_sum[r][c]);
    }
  }
}

}  // namespace

// Copy the 16 partner masks into constant memory of the current device.
// Synchronises, so that no later launch on any stream can see the old table.
extern "C" int pt_set_partner_mask(const uint16_t* mask16) {
  cudaError_t err = cudaMemcpyToSymbol(PARTNER_MASK, mask16,
                                       16 * sizeof(uint16_t));
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

// matches, homs: int32 [na, nb] row-major, zeroed by the caller. a and b:
// uint8 rows of `width` packed bytes at strides lda and ldb; width, lda,
// ldb and both base addresses are multiples of 16. symmetric=1 needs
// a == b and fills only cells whose 64-tile has tile_j >= tile_i (every
// cell i <= j among them). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pt_cross_counts(const uint8_t* a, int64_t lda, int na,
                               const uint8_t* b, int64_t ldb, int nb,
                               int64_t width, int32_t* matches,
                               int32_t* homs, int symmetric, void* stream) {
  if (na <= 0 || nb <= 0 || width <= 0) return cudaSuccess;
  if (width % 16 || lda % 16 || ldb % 16 || lda < width || ldb < width)
    return cudaErrorInvalidValue;
  if (symmetric && (a != b || na != nb || lda != ldb))
    return cudaErrorInvalidValue;
  const int64_t tiles_i = (na + kTile - 1) / kTile;
  const int64_t tiles_j = (nb + kTile - 1) / kTile;
  if (tiles_i > 65535) return cudaErrorInvalidValue;

  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  const int64_t live = symmetric ? tiles_i * (tiles_i + 1) / 2
                                 : tiles_i * tiles_j;
  const int64_t total_stages = (width + kStage - 1) / kStage;
  int64_t splits = (static_cast<int64_t>(kBlocksPerSm) * sms + live - 1) / live;
  splits = splits < 1 ? 1 : (splits > total_stages ? total_stages : splits);
  if (splits > 65535) splits = 65535;
  const int64_t per_split = (total_stages + splits - 1) / splits;
  splits = (total_stages + per_split - 1) / per_split;

  const dim3 grid(static_cast<unsigned>(tiles_j),
                  static_cast<unsigned>(tiles_i),
                  static_cast<unsigned>(splits));
  cross_counts_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, lda, na, b, ldb, nb, width, per_split, matches, homs, symmetric);
  return cudaGetLastError();
}
