// All-pairs match and homolog counts over split-nibble packed pileup rows,
// contracted as int8 one-hot planes on Hopper's tensor cores.
//
// What it replaces: the two Pallas kernels of the JAX package,
// phylonium_tpu/ops/pallas_match.py::_count_kernel_packed (:108, the square
// all-pairs block) and ::_cross_kernel_packed (:217, the rectangular
// panels). Both compute one function, so one kernel serves both: a
// symmetric call (a == b) counts the upper-triangle tiles only.
//
// Input rows are uint8, each byte holding two pileup states (low nibble =
// column j, high nibble = column j + ceil(L/2); ops/shapes.py::pack_states).
// For every row pair (i, j) and every column:
//
//     matches[i, j] += MATCH_TABLE[sa, sb]
//     homs[i, j]    += (sa < 10) & (sb < 10)
//
// As on the TPU (pallas_match.py:63-93) both are products of 0/1 planes:
// matches = sum_s P_s . Q_s^T with P_s = [state == s] on the A rows and
// Q_s = sum_{t in partners(s)} P_t on the B rows (partner states are
// distinct, so Q_s is 0/1 too), and homs = V . V^T with V = [state < 10].
// States with one partner set share a plane pair: P_c is the union of
// their P_s (0/1, since a column holds one state) and Q_c their common
// partner plane. The match table has 8 such classes (C fwd with G rev,
// G fwd with C rev; the rest alone), so 8 planes, not 10, count matches.
// The padding byte 0xAA holds INVALID (10) twice: it lies in no plane.
//
// What bounds it: int8 tensor-core operations. Per cell and column the
// contraction does 9 multiply-adds (8 planes for matches, 1 for homs),
// 18 int8 operations: at 600 x 1 Mbp the 180,300 cells of the upper
// triangle need about 3.2 T operations, about 1.64 ms at the H100's
// 1,979 TOP/s, against 0.09 ms to read the 300 MB of packed rows. At
// 29 x 5 Mbp reading the 72.5 MB of rows (about 0.022 ms) sets the bound.
// What the design does about it:
//
// - mma.sync.m16n8k32 s8 x s8 -> s32 on operands in shared memory
//   (ldmatrix). wgmma reaches the full int8 rate; mma.sync is the simpler
//   first design: its fragments map one to one onto the packed layout (a
//   thread's 4 bytes of k are 4 consecutive states), and its results are
//   easy to hold against the plain version. Sums are exact in int32.
// - The expansion from nibbles to one-hot bytes is integer work that the
//   MMA amortises over a 128 x 128 tile: one expansion per staged byte per
//   tile, in shared memory. A packed 32-bit word w selects, through the
//   byte permute `prmt` with w (and w >> 16) as the selector, one plane's
//   values for its 8 states from an 8-byte table; the selector nibble's top
//   bit takes the table byte's sign, which holds the plane for states
//   8..15. One prmt and one and give 4 one-hot bytes of a plane, P and Q
//   planes alike (the tables are built from PARTNER_MASK, one pair a
//   class of states).
//   K is ordered plane-major within a stage: a stage of 16 packed bytes is
//   32 states, one k32 slab of each plane, in packed nibble order on both
//   sides.
// - A ring of 4 shared-memory stages filled with cp.async: the next
//   stages' loads overlap this stage's expansion and MMA. Two blocks fit
//   on an SM, so one block's expansion overlaps the other's MMA.
// - Blocks on Hopper run in no order, so the grid's third dimension splits
//   the columns and the splits atomicAdd into outputs that start zeroed:
//   exact and deterministic in any order. It fills the card at 29 genomes
//   (one tile). When a tile's rows leave warps without output, the busy
//   warp tiles are replicated and each replica takes every R-th plane.
// - Panels of at most 32 rows (the 29-genome main path) would leave three
//   quarters of a tile's buffer empty and pay a whole iteration's barriers
//   and latency for one 16-byte stage. There the buffer holds 4 stages of
//   the same 32 rows, and an iteration does 4 stages' 32 x 32 products.
// - matches and homs are two launches of one kernel template, so that a
//   warp holds one 64 x 32 accumulator tile (64 registers) and two blocks
//   fit on an SM.
//
// int32 sums are exact while a cell counts fewer than 2^31 columns; the
// Python wrapper counts wider rows in column chunks (views of the panel at
// its full row stride) and sums the chunks in int64.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;            // output rows and columns per block
constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 16;       // packed bytes of a row per stage
constexpr int kDepth = 4;             // stages in the cp.async ring
constexpr int kRowBytes = 32;         // one plane's k32 slab of a row
constexpr int kRingBytes = kDepth * kThreads * kStageBytes;
constexpr int kStates = 10;           // valid states; INVALID is 10
constexpr int kMatchPlanes = 8;       // classes of states by partner set

// prmt tables, two words each: byte k (0..7) holds the plane's value of
// state k in bit 0 and of state k + 8 in bit 7. MATCH_POOLS[0][c] is P_c,
// MATCH_POOLS[1][c] is Q_c; VALID_POOL is V. Uploaded by
// pt_set_partner_mask.
__constant__ uint32_t MATCH_POOLS[2][kMatchPlanes][2];
__constant__ uint32_t VALID_POOL[2];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte chunk `chunk` (0 or 1) of expanded row `row`: the
// chunk index is flipped every 4 rows, so that ldmatrix's 8 rows of one
// chunk and the expansion's stores fall in distinct banks.
__device__ __forceinline__ int chunk_offset(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ ((row >> 2) & 1)) << 4);
}

template <int kMode>
struct Planes {
  static constexpr int kCount = kMode == 0 ? kMatchPlanes : 1;
  static constexpr int kExpBytes = 2 * kCount * kTile * kRowBytes;
  static constexpr int kSmemBytes = kRingBytes + kExpBytes;
};

// Rows of a group in the grouped layout: with kGroups = 4 (panels of at
// most 32 rows), the 128 rows of a tile buffer hold 4 consecutive stages
// of the same 32 rows, so that one iteration does 4 stages of work.
constexpr int kGroupRows = 32;

// Expand this thread's 4 items (row, 32-bit word) of one side's staged
// bytes into the side's planes. kSide is a template argument so that the
// tables are read from constant memory at fixed offsets. `live` is the
// number of stages of this iteration that exist; rows of a later stage
// expand as INVALID, to zero planes.
template <int kMode, int kSide, int kGroups>
__device__ __forceinline__ void expand(const uint8_t* slot, uint8_t* planes,
                                       int lrow, int rows, int live) {
  constexpr int kPlanes = Planes<kMode>::kCount;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lrow + k * kTile;
    const int row = e >> 2;
    const int q = e & 3;
    const int data_row = kGroups == 1 ? row : row % kGroupRows;
    if (data_row < rows) {
      const bool staged = kGroups == 1 || row / kGroupRows < live;
      const uint32_t w =
          staged ? *reinterpret_cast<const uint32_t*>(slot + row * kStageBytes + q * 4)
                 : 0xAAAAAAAAu;
      const uint32_t w_hi = w >> 16;
      // word q holds states 8q .. 8q + 7 of the stage's 32, in packed
      // nibble order: half q >> 1 of the row's 32 bytes, 8 bytes in
      uint8_t* dst = planes + chunk_offset(row, q >> 1) + (q & 1) * 8;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const uint32_t lo = kMode == 0 ? MATCH_POOLS[kSide][p][0] : VALID_POOL[0];
        const uint32_t hi = kMode == 0 ? MATCH_POOLS[kSide][p][1] : VALID_POOL[1];
        uint2 v;
        v.x = prmt(lo, hi, w) & 0x01010101u;
        v.y = prmt(lo, hi, w_hi) & 0x01010101u;
        *reinterpret_cast<uint2*>(dst + p * kTile * kRowBytes) = v;
      }
    }
  }
}

// kMode 0 counts matches (P planes against Q planes), kMode 1 homologs
// (V against V) into `out`, int32 [na, nb], zeroed by the caller.
// kGroups 1: one stage an iteration over a 128 x 128 tile. kGroups 4
// (na, nb <= 32): four stages an iteration, each a 32 x 32 product.
// stages_per_split is a multiple of kGroups.
template <int kMode, int kGroups>
__global__ void __launch_bounds__(kThreads, 2)
pair_mma_kernel(const uint8_t* __restrict__ a, int64_t lda, int na,
                const uint8_t* __restrict__ b, int64_t ldb, int nb,
                int64_t total_stages, int64_t stages_per_split,
                int32_t* __restrict__ out, int symmetric) {
  constexpr int kPlanes = Planes<kMode>::kCount;
  constexpr int kMTiles = kGroups == 1 ? 4 : 2;  // 16-row tiles of a warp
  const int tile_i = blockIdx.y;
  const int tile_j = blockIdx.x;
  if (symmetric && tile_j < tile_i) return;
  const int64_t s_begin = blockIdx.z * stages_per_split;
  const int64_t s_end = s_begin + stages_per_split < total_stages
                            ? s_begin + stages_per_split
                            : total_stages;

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* expd = smem + kRingBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = tile_i * kTile;
  const int j0 = tile_j * kTile;
  const int rows_a = na - i0 < kTile ? na - i0 : kTile;
  const int rows_b = nb - j0 < kTile ? nb - j0 : kTile;

  // planes of rows beyond na / nb stay zero: they add nothing
  for (int k = tid; k < Planes<kMode>::kExpBytes / 16; k += kThreads) {
    reinterpret_cast<uint4*>(expd)[k] = make_uint4(0u, 0u, 0u, 0u);
  }

  // loading: thread t stages buffer row t of A (t < 128) or t - 128 of B;
  // buffer row r is data row r (kGroups 1) or data row r % 32 of the
  // iteration's stage r / 32 (kGroups 4)
  const int side = tid >> 7;
  const int lrow = tid & (kTile - 1);
  const int side_rows = side ? rows_b : rows_a;
  const int data_row = kGroups == 1 ? lrow : lrow % kGroupRows;
  const int64_t my_stage = kGroups == 1 ? 0 : lrow / kGroupRows;
  const bool loads = data_row < side_rows;
  const uint8_t* src =
      side ? b + static_cast<int64_t>(j0 + (loads ? data_row : 0)) * ldb
           : a + static_cast<int64_t>(i0 + (loads ? data_row : 0)) * lda;
  src += my_stage * kStageBytes;
  const uint32_t ring_slot0 = smem_addr(ring) + tid * kStageBytes;

#pragma unroll
  for (int d = 0; d < kDepth - 1; ++d) {
    const int64_t s = s_begin + d * kGroups;
    if (loads && s + my_stage < s_end)
      cp_async16(ring_slot0 + d * kThreads * kStageBytes, src + s * kStageBytes);
    cp_async_commit();
  }

  uint8_t* exp_side = expd + side * kPlanes * kTile * kRowBytes;

  // MMA roles. kGroups 1: warp tiles of 64 x 32 that hold output rows,
  // replicated over the idle warps. kGroups 4: warp w multiplies stage
  // w % 4's 32 x 32 block, two replicas. Replica r takes planes r, r + R.
  int reps, rep, a_row0, b_row0, out_row0, out_col0;
  if (kGroups == 1) {
    const int act_n = (rows_b + 31) / 32;
    const int act = ((rows_a + 63) / 64) * act_n;
    const int role = warp % act;
    reps = kWarps / act;
    rep = warp / act;
    a_row0 = out_row0 = (role / act_n) * 64;
    b_row0 = out_col0 = (role % act_n) * 32;
  } else {
    reps = kWarps / kGroups;
    rep = warp / kGroups;
    a_row0 = b_row0 = (warp % kGroups) * kGroupRows;
    out_row0 = out_col0 = 0;
  }
  const bool mma_warp = rep < reps;

  int32_t acc[kMTiles][4][4];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;

  const uint32_t exp_a = smem_addr(expd);
  const uint32_t exp_b = exp_a + kPlanes * kTile * kRowBytes;

  for (int64_t s = s_begin; s < s_end; s += kGroups) {
    const int it = static_cast<int>((s - s_begin) / kGroups);
    const int64_t next = s + (kDepth - 1) * kGroups;
    // the slot of the previous iteration: every thread finished expanding
    // it before that iteration's second barrier
    if (loads && next + my_stage < s_end)
      cp_async16(ring_slot0 + ((it + kDepth - 1) % kDepth) * kThreads * kStageBytes,
                 src + next * kStageBytes);
    cp_async_commit();
    cp_async_wait<kDepth - 1>();
    __syncthreads();  // this iteration has landed; the last MMA left the planes

    // expansion: item e = (row, word) of this side, 4 items a thread
    const uint8_t* slot = ring + (it % kDepth) * kThreads * kStageBytes +
                          side * kTile * kStageBytes;
    const int live = static_cast<int>(s_end - s < kGroups ? s_end - s : kGroups);
    if (side == 0)
      expand<kMode, 0, kGroups>(slot, exp_side, lrow, side_rows, live);
    else
      expand<kMode, 1, kGroups>(slot, exp_side, lrow, side_rows, live);
    __syncthreads();  // the planes of this iteration are complete

    if (mma_warp) {
      for (int p = rep; p < kPlanes; p += reps) {
        uint32_t af[kMTiles][4];
        uint32_t bf[4][2];
        const uint32_t pa = exp_a + p * kTile * kRowBytes;
        const uint32_t pb = exp_b + p * kTile * kRowBytes;
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
          const int row = a_row0 + mi * 16 + (lane & 15);
          ldmatrix_x4(af[mi], pa + chunk_offset(row, lane >> 4));
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int row = b_row0 + nj * 16 + ((lane >> 4) << 3) + (lane & 7);
          uint32_t r[4];
          ldmatrix_x4(r, pb + chunk_offset(row, (lane >> 3) & 1));
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  if (!mma_warp) return;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + out_row0 + mi * 16 + (lane >> 2) + 8 * h;
      if (i >= na) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + out_col0 + ni * 8 + (lane & 3) * 2 + c;
          const int32_t v = acc[mi][ni][2 * h + c];
          if (j < nb && v) atomicAdd(out + static_cast<int64_t>(i) * nb + j, v);
        }
      }
    }
  }
}

// The prmt table of a plane whose value for state x is bit x of `bits`.
void pool_of(uint32_t bits, uint32_t (&pool)[2]) {
  uint8_t bytes[8];
  for (int k = 0; k < 8; ++k) {
    bytes[k] = static_cast<uint8_t>(((bits >> k) & 1u) |
                                    (((bits >> (k + 8)) & 1u) << 7));
  }
  for (int w = 0; w < 2; ++w) {
    pool[w] = 0;
    for (int k = 0; k < 4; ++k)
      pool[w] |= static_cast<uint32_t>(bytes[4 * w + k]) << (8 * k);
  }
}

template <int kMode, int kGroups>
cudaError_t launch(const uint8_t* a, int64_t lda, int na, const uint8_t* b,
                   int64_t ldb, int nb, int64_t width, int32_t* out,
                   int symmetric, cudaStream_t stream) {
  constexpr int kSmem = Planes<kMode>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(pair_mma_kernel<kMode, kGroups>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return err;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_mma_kernel<kMode, kGroups>, kThreads, kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;

  const int64_t tiles_i = (na + kTile - 1) / kTile;
  const int64_t tiles_j = (nb + kTile - 1) / kTile;
  const int64_t live = symmetric ? tiles_i * (tiles_i + 1) / 2 : tiles_i * tiles_j;
  const int64_t total_stages = width / kStageBytes;
  const int64_t total_iters = (total_stages + kGroups - 1) / kGroups;
  // one wave of resident blocks: each split a long run of iterations
  int64_t splits = static_cast<int64_t>(per_sm) * sms / live;
  splits = splits < 1 ? 1 : (splits > total_iters ? total_iters : splits);
  if (splits > 65535) splits = 65535;
  const int64_t per_split = (total_iters + splits - 1) / splits;
  splits = (total_iters + per_split - 1) / per_split;

  const dim3 grid(static_cast<unsigned>(tiles_j), static_cast<unsigned>(tiles_i),
                  static_cast<unsigned>(splits));
  pair_mma_kernel<kMode, kGroups><<<grid, kThreads, kSmem, stream>>>(
      a, lda, na, b, ldb, nb, total_stages, per_split * kGroups, out, symmetric);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const uint8_t* a, int64_t lda, int na, const uint8_t* b,
                        int64_t ldb, int nb, int64_t width, int32_t* out,
                        int symmetric, cudaStream_t stream) {
  if (na <= kGroupRows && nb <= kGroupRows)
    return launch<kMode, kTile / kGroupRows>(a, lda, na, b, ldb, nb, width, out,
                                             symmetric, stream);
  return launch<kMode, 1>(a, lda, na, b, ldb, nb, width, out, symmetric, stream);
}

}  // namespace

// Build the plane tables from the 16 partner masks (bit t of entry s is
// MATCH_TABLE[s, t]) and copy them into constant memory of the current
// device. States with equal masks share one plane pair; a state with no
// partner adds nothing and gets none; planes beyond the classes stay
// zero. Fails if the table has more than kMatchPlanes classes.
// Synchronises, so that no later launch on any stream can see the old
// tables.
extern "C" int pt_set_partner_mask(const uint16_t* mask16) {
  uint32_t p_bits[kMatchPlanes] = {};
  uint32_t q_bits[kMatchPlanes] = {};
  int classes = 0;
  for (int s = 0; s < kStates; ++s) {
    if (!mask16[s]) continue;
    int c = 0;
    while (c < classes && q_bits[c] != mask16[s]) ++c;
    if (c == classes) {
      if (classes == kMatchPlanes) return cudaErrorInvalidValue;
      q_bits[classes++] = mask16[s];
    }
    p_bits[c] |= 1u << s;
  }
  uint32_t pools[2][kMatchPlanes][2];
  uint32_t valid[2];
  for (int c = 0; c < kMatchPlanes; ++c) {
    pool_of(p_bits[c], pools[0][c]);
    pool_of(q_bits[c], pools[1][c]);
  }
  pool_of((1u << kStates) - 1u, valid);
  cudaError_t err = cudaMemcpyToSymbol(MATCH_POOLS, pools, sizeof(pools));
  if (err != cudaSuccess) return err;
  err = cudaMemcpyToSymbol(VALID_POOL, valid, sizeof(valid));
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

// matches, homs: int32 [na, nb] row-major, zeroed by the caller. a and b:
// uint8 rows of `width` packed bytes at strides lda and ldb; width, lda,
// ldb and both base addresses are multiples of 16. symmetric=1 needs
// a == b and fills only cells whose 128-tile has tile_j >= tile_i (every
// cell i <= j among them). Launches the matches and then the homologs
// kernel on `stream` and returns the first launch error.
extern "C" int pt_cross_counts(const uint8_t* a, int64_t lda, int na,
                               const uint8_t* b, int64_t ldb, int nb,
                               int64_t width, int32_t* matches,
                               int32_t* homs, int symmetric, void* stream) {
  if (na <= 0 || nb <= 0 || width <= 0) return cudaSuccess;
  if (width % 16 || lda % 16 || ldb % 16 || lda < width || ldb < width)
    return cudaErrorInvalidValue;
  if (symmetric && (a != b || na != nb || lda != ldb))
    return cudaErrorInvalidValue;
  if ((na + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_mode<0>(a, lda, na, b, ldb, nb, width, matches, symmetric, s);
  if (err != cudaSuccess) return err;
  return launch_mode<1>(a, lda, na, b, ldb, nb, width, homs, symmetric, s);
}
