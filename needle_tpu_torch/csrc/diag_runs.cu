// Diagonal-run count walk of the all-pairs search, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel needle_tpu/search/pallas_impl.py::_kernel
// (launched by the pallas_call in _batch_counts_pallas_jit). It computes the
// same counts; it is not a block-by-block translation (the TPU kernel's
// (8, 512) sublane groups, lane rolls and SMEM/VMEM staging are Mosaic
// layout).
//
// What it computes. For pair p of a chunk and diagonal index d in
// [0, n_out), offset o = d - (n_pad - 1): the number of maximal runs of
// cells (i, j = i + o) with popcount(src[p][i] ^ dst[p][j]) <= thr[p],
// 1 <= i < nv[p], 1 <= j < mv[p], that are at least max(lm[p], 1) long.
// Rows are grouped in 512-row blocks, row i in block b = (i + 1) / 512. A
// block whose bit (bm[p][g] >> min(b, 31)) & 1 is clear, g = d / (8 * 512),
// is skipped; the carry is flushed at the gap (a live run >= l_min is
// counted there, a shorter one is dropped), which equals treating every row
// of the block as a mismatch. Diagonals d >= 2 * n_pad - 1 get 0.
//
// Design (diag_runs_mma_kernel, the one the port launches). A thread block
// owns a band of 256 diagonals of one pair (all in one mask group, so the
// mask bits are uniform across the block) and walks down the rows in tiles
// of 256, aligned to the mask blocks (tile t holds rows 256t - 1 ..
// 256t + 254, all in block t / 2), over the union of its diagonals' valid
// rows. Per tile:
//
//   1. Staging: the tile's 272 src hashes and the 520 dst hashes its band
//      reads go to shared memory, each expanded from u32 to 32 int8 of +/-1
//      in the mma fragment order; the kernel reads the u32 rows from device
//      memory itself.
//   2. Distances on the int8 tensor cores: dot(a, b) of two +/-1 vectors is
//      32 - 2 * popcount(x ^ y), so a cell matches iff dot >= 32 - 2 * thr,
//      exact in int32. The products start at -(32 - 2 * thr), so a cell
//      matches iff the sign bit of its result is clear. The band's cells
//      are cut into 17 stripes; stripe u, step s is one
//      mma.sync.m16n8k32.s8 of tile rows 8s .. 8s + 15 by columns
//      8s + 16u .. 8s + 16u + 7, and steps -1 .. 31 cover every cell of
//      the band once. In that order each lane always holds the same four
//      diagonals, one row in eight of each.
//   3. Epilogue: each lane shifts the sign bit of each result into a phase
//      word (one funnel shift a cell, no compare, no atomics): bit s = row
//      8s + g of its diagonal. After the tile it stores its phase words to
//      shared memory. A warp takes two or three adjacent stripes, so a step
//      loads one new A row and one new B fragment (the rest are the
//      previous steps').
//   4. Runs from words: thread k (diagonal d0 + k) reads its 8 phase words,
//      turns them into eight 32-row words with an 8 x 8 bit transpose, keeps
//      only its valid rows (an explicit predicate: 1 <= i < nv and
//      1 <= i + o < mv; invalid cells are never trusted to mismatch, since a
//      zero hash matches at thr >= 16), and updates its carry (run length,
//      count) in registers: an all-ones word extends the run; otherwise the
//      low-order ones close the carry, the runs wholly inside the word are
//      counted with a shift-and ladder (when l_min <= 30), and the
//      high-order ones open the next carry.
//
// A masked-off tile is neither staged nor multiplied: every thread flushes
// its carry. A run live after the last tile ends there.
//
// Bound and ceiling. Per walked cell the card must do a 32-deep +/-1 dot
// product (64 int8 operations); the hash rows in and the counts out are a
// few bytes per diagonal, so the bound is set by operations: 1,979 TOP/s of
// int8, ~3.1e13 cells/s. mma.sync reaches only part of that on the H100
// (needle_tpu_torch/bench/mma_sync_rate.cu): m16n8k32.s8 issues at most
// ~0.32 a clock per SM (~680 TOP/s, 34% of the peak), ~0.20 with an 8-byte
// shared-memory load and the four shifts beside each, as here. With 128
// cells a product that caps this design near 6.7e12 cells/s, ~21% of the
// bound; the staging and the run step, which keep the tensor cores idle,
// hold it lower (needle_tpu_torch/bench/walk_parts.py takes the phases
// apart). wgmma and TMA lift the first limit.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kDTile = 512;    // diagonals per tile, and rows per mask block
constexpr int kGTiles = 8;     // tiles per mask group

// ---- the tensor-core walk --------------------------------------------------

constexpr int kBand = 256;        // diagonals per block, one thread each
constexpr int kRows = 256;        // rows per tile: 32 steps of 8 rows
constexpr int kSteps = kRows / 8;
constexpr int kStripes = kBand / 16 + 1;  // 16 diagonals' worth of cells each
// warp w takes stripes 2w and 2w + 1, the last warp also stripe 16
constexpr int kWarps = kBand / 32;
static_assert(kStripes == 2 * kWarps + 1, "8 warps of 2 stripes, the last of 3");
constexpr int kHashWords = 8;     // 32 int8 of +/-1 in u32 words
// staged src rows -8 .. kRows + 7 and dst columns -8 .. kBand + kRows - 1
// of the tile (rows and columns relative to its first row and column)
constexpr int kSrcHashes = kRows + 16;
constexpr int kDstHashes = kBand + kRows + 8;

// stripes also produce the diagonals -15 .. -1 and kBand .. kBand + 7:
// their phase words land in pads that are never read
constexpr int kPad = 16;
static_assert((kGTiles * kDTile) % kBand == 0, "a band lies in one mask group");
static_assert(kDTile % kRows == 0, "a tile lies in one mask block");
static_assert(kSteps == 32, "one bit a step in a 32-bit phase register");

// Bits 0..3 of v as four int8 of +/-1 (bit q set -> +1 in byte q, clear ->
// -1). Spread bit q to bit 8q, then map each byte b in {0, 1} to ~(0xFE b).
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t v) {
  const uint32_t s = ((v & 0xFu) * 0x00204081u) & 0x01010101u;
  return ~(s * 0xFEu);
}

// Half of one hash's 8 staged words, in the mma fragment order: word 2q
// holds bits 4q..4q+3 (k = 4q..4q+3 of the product), word 2q + 1 bits
// 16+4q..16+4q+3, so lane t of a quad reads its two registers as one uint2.
// half 0 writes words 0..3 (q = 0, 1), half 1 words 4..7 (q = 2, 3).
__device__ __forceinline__ void stage_half(uint32_t* hash_words, uint32_t x,
                                           int half) {
  x >>= 8 * half;
  reinterpret_cast<uint4*>(hash_words)[half] = make_uint4(
      pm1_nibble(x), pm1_nibble(x >> 16), pm1_nibble(x >> 4), pm1_nibble(x >> 20));
}

// c = A (16 x 32, row) * B (32 x 8, col) + c_in, s8 in, s32 out. Lane
// (g, t) = (lane / 4, lane % 4) holds a0/a2 = row g, k 4t..4t+3 / 16+4t..;
// a1/a3 = row g + 8; b0/b1 = column g, k 4t.. / 16+4t..; c0, c1 = row g,
// columns 2t, 2t + 1; c2, c3 = row g + 8. a and c_in are passed as four
// registers each, so that the compiler keeps them in place between calls.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint2 b, const int32_t (&c_in)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=&r"(c[0]), "=&r"(c[1]), "=&r"(c[2]), "=&r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(c_in[0]), "r"(c_in[1]), "r"(c_in[2]), "r"(c_in[3]));
}

// Shift the sign bit of c (set: a mismatch) into bit 0 of acc.
__device__ __forceinline__ uint32_t push_sign(uint32_t acc, int32_t c) {
  return __funnelshift_l(static_cast<uint32_t>(c), acc, 1);
}

// One step s of the warp's kN adjacent stripes u0 .. u0 + kN - 1: tile rows
// 8s .. 8s + 15 times columns 8s + 16u .. 8s + 16u + 7. The A fragment
// (rows 8s + g as a0/a2, 8s + 8 + g as a1/a3) moves on by one row pair:
// rows 8s + g were the previous step's high rows. Stripe u's columns at
// step s are stripe u + 1's at step s - 2, so b (the fragments of step
// s - 2, kept per parity) moves on by one stripe and only the last is
// loaded, unless kFresh. Then the sign bits of elements 0, 1 (rows 8s + g)
// go into the stripes' phase accumulators if kLo, of elements 2, 3 (rows
// 8s + 8 + g) if kHi.
template <int kN, bool kFresh, bool kLo, bool kHi>
__device__ __forceinline__ void walk_step(uint32_t (&acc)[kN][4], uint32_t (&a)[4],
                                          uint2 (&b)[kN], const uint32_t* a_row,
                                          const uint32_t* b_col, int u0, int s,
                                          const int32_t (&c_in)[4]) {
  const uint2 hi = *reinterpret_cast<const uint2*>(a_row + (8 * s + 8) * kHashWords);
  a[0] = a[1];
  a[2] = a[3];
  a[1] = hi.x;
  a[3] = hi.y;
  const uint32_t* col = b_col + (8 * s + 16 * u0) * kHashWords;
#pragma unroll
  for (int v = 0; v < kN; ++v) {
    if (kFresh || v == kN - 1) {
      b[v] = *reinterpret_cast<const uint2*>(col + 16 * v * kHashWords);
    } else {
      b[v] = b[v + 1];
    }
  }
#pragma unroll
  for (int v = 0; v < kN; ++v) {
    int32_t c[4];
    mma_s8(c, a, b[v], c_in);
    if (kLo) {
      acc[v][0] = push_sign(acc[v][0], c[0]);
      acc[v][1] = push_sign(acc[v][1], c[1]);
    }
    if (kHi) {
      acc[v][2] = push_sign(acc[v][2], c[2]);
      acc[v][3] = push_sign(acc[v][3], c[3]);
    }
  }
}

// The warp's kN adjacent stripes u0 .. over one tile (steps -1 .. 31), then
// their match bits into the phase words: bit s of s_phase[(k + kPad) * 8 + g]
// = row 8s + g of diagonal k (elements 2, 3 of step s are rows 8(s + 1) + g).
// Every cell's bit is written, valid or not.
template <int kN>
__device__ __forceinline__ void walk_tile(uint32_t* s_phase, const uint32_t* a_row,
                                          const uint32_t* b_col, int u0, int g,
                                          int tq, const int32_t (&c_in)[4]) {
  uint32_t acc[kN][4] = {};
  uint32_t a[4];
  uint2 b_odd[kN], b_even[kN];  // the last odd and even step's B fragments
  const uint2 lo = *reinterpret_cast<const uint2*>(a_row - 8 * kHashWords);
  a[1] = lo.x;  // rows -8 + g, the high rows of step -2
  a[3] = lo.y;
  walk_step<kN, true, false, true>(acc, a, b_odd, a_row, b_col, u0, -1, c_in);
  walk_step<kN, true, true, true>(acc, a, b_even, a_row, b_col, u0, 0, c_in);
#pragma unroll 2
  for (int s = 1; s < kSteps - 1; s += 2) {
    walk_step<kN, false, true, true>(acc, a, b_odd, a_row, b_col, u0, s, c_in);
    walk_step<kN, false, true, true>(acc, a, b_even, a_row, b_col, u0, s + 1, c_in);
  }
  walk_step<kN, false, true, false>(acc, a, b_odd, a_row, b_col, u0, kSteps - 1,
                                    c_in);
#pragma unroll
  for (int v = 0; v < kN; ++v) {
    const int kd = 16 * (u0 + v) + 2 * tq - g + kPad;
    s_phase[kd * 8 + g] = ~__brev(acc[v][0]);
    s_phase[(kd + 1) * 8 + g] = ~__brev(acc[v][1]);
    s_phase[(kd - 8) * 8 + g] = ~__brev(acc[v][2]);
    s_phase[(kd - 7) * 8 + g] = ~__brev(acc[v][3]);
  }
}

// Bits [lo, hi) of a 32-bit word, each bound clamped to [0, 32].
__device__ __forceinline__ uint32_t span_bits(int lo, int hi) {
  lo = min(max(lo, 0), 32);
  hi = min(max(hi, 0), 32);
  return hi > lo ? (0xFFFFFFFFu >> (32 - (hi - lo))) << lo : 0u;
}

// Fold one 32-row word of match bits (bit r = row r of the word, in walk
// order) into a diagonal's carry: `run` is the length of the run of matches
// that ends at the previous row, `cand` the runs >= l_min closed so far.
__device__ __forceinline__ void runs_word(uint32_t x, int l_min, int& run,
                                          int& cand) {
  if (x == 0xFFFFFFFFu) {
    run += 32;
    return;
  }
  if (x == 0u) {
    cand += run >= l_min;
    run = 0;
    return;
  }
  const int lo = __ffs(~x) - 1;  // low-order ones extend the carry, which ends
  cand += run + lo >= l_min;
  const int hi = __clz(~x);      // high-order ones open the next carry
  if (l_min <= 30) {             // a run inside the word is at most 30 long
    // z: the runs wholly inside the word; then bit i of z set iff rows
    // i .. i + l_min - 1 all match, and each run's first such i counts
    uint32_t z = x & (0xFFFFFFFFu << lo) & (0xFFFFFFFFu >> hi);
    int len = 1;
    while (2 * len <= l_min) {
      z &= z >> len;
      len *= 2;
    }
    z &= z >> (l_min - len);
    cand += __popc(z & ~(z << 1));
  }
  run = hi;
}

// Transpose the 8 x 8 bit blocks of eight phase words: afterwards byte b of
// p[i] holds bit 8b + i of p[0..7] (bit j from p[j]).
__device__ __forceinline__ void transpose8(uint32_t (&p)[8]) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
    const uint32_t mask = k == 4 ? 0x0F0F0F0Fu : k == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j & k) continue;
      const uint32_t t = ((p[j] >> k) ^ p[j + k]) & mask;
      p[j + k] ^= t;
      p[j] ^= t << k;
    }
  }
}

__global__ void __launch_bounds__(kBand)
diag_runs_mma_kernel(const int32_t* __restrict__ nv,
                     const int32_t* __restrict__ mv,
                     const int32_t* __restrict__ lm,
                     const int32_t* __restrict__ thr,
                     const int32_t* __restrict__ bm, int n_groups,
                     const uint32_t* __restrict__ src,
                     const uint32_t* __restrict__ dst,
                     int32_t* __restrict__ counts, int n_pad, int n_out) {
  __shared__ __align__(16) uint32_t s_src[kSrcHashes * kHashWords];
  __shared__ __align__(16) uint32_t s_dst[kDstHashes * kHashWords];
  // match bits of diagonal k at rows 8s + g of the tile: word
  // s_phase[(k + kPad) * 8 + g], bit s
  __shared__ __align__(16) uint32_t s_phase[(kBand + 2 * kPad) * 8];

  const int p = blockIdx.y;
  const uint32_t* g_src = src + static_cast<size_t>(p) * n_pad;
  const uint32_t* g_dst = dst + static_cast<size_t>(p) * n_pad;
  const int n_diag = 2 * n_pad - 1;
  const int nv_p = min(nv[p], n_pad);
  const int mv_p = min(mv[p], n_pad);
  const int l_min = max(lm[p], 1);
  // popcount <= thr  <=>  dot >= 32 - 2 * thr (thr clamped to [-1, 32]);
  // the products start at -(32 - 2 * thr), so a cell matches iff the sign
  // bit of its result is clear
  int32_t c_in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // four registers, not one copied four times
    asm volatile("mov.b32 %0, %1;"
                 : "=r"(c_in[q])
                 : "r"(-(32 - 2 * min(max(thr[p], -1), 32))));
  }
  const int d0 = blockIdx.x * kBand;
  // one mask group per thread block, so every thread reads the same bits
  const int bits = bm[static_cast<size_t>(p) * n_groups + d0 / (kGTiles * kDTile)];
  const int o0 = d0 - (n_pad - 1);
  // rows that any diagonal of the band walks: lo falls and hi falls as o
  // grows, so the union is [lo(last o), hi(first o))
  const int o_last = min(d0 + kBand, n_diag) - 1 - (n_pad - 1);
  const int lo_u = max(1, 1 - o_last);
  const int hi_u = min(nv_p, mv_p - o0);

  const int k = threadIdx.x;  // this thread's diagonal in the band
  // its valid rows [lo, hi): 1 <= i < nv and 1 <= i + o < mv (empty for
  // d >= 2 * n_pad - 1, where o >= n_pad >= mv)
  const int lo = max(1, 1 - (o0 + k));
  const int hi = min(nv_p, mv_p - (o0 + k));
  const int warp = k >> 5;
  const int g = (k & 31) >> 2;
  const int tq = k & 3;
  const int half = k & 1;  // staging: half of hashes k / 2 + j * kBand / 2

  int run = 0;
  int cand = 0;
  // control flow of this loop is uniform across the block (lo_u, hi_u and
  // bits are), so the barriers inside are reached by every thread
  const int t_first = (lo_u + 1) / kRows;
  const int t_last = lo_u < hi_u ? hi_u / kRows : t_first - 1;
  for (int t = t_first; t <= t_last; ++t) {
    if (((bits >> min(t / (kDTile / kRows), 31)) & 1) == 0) {
      cand += run >= l_min;  // flush the carry at the gap
      run = 0;
      continue;
    }
    const int rs = t * kRows - 1;  // row of tile row 0
    const int cs = rs + o0;        // dst index of tile column 0
    // the previous tile's products were done before its second barrier
    for (int h = k >> 1; h < kSrcHashes + kDstHashes; h += kBand / 2) {
      if (h < kSrcHashes) {
        const int i = rs - 8 + h;
        stage_half(s_src + h * kHashWords, (i >= 0 && i < n_pad) ? g_src[i] : 0u,
                   half);
      } else {
        const int j = cs - 8 + (h - kSrcHashes);
        stage_half(s_dst + (h - kSrcHashes) * kHashWords,
                   (j >= 0 && j < n_pad) ? g_dst[j] : 0u, half);
      }
    }
    __syncthreads();

    // lane (g, tq) of stripe u always sees diagonals 16u + 2tq - g + e
    // (rows 8s + g, elements e = 0, 1) and the same - 8 (rows 8s + 8 + g,
    // elements 2, 3); steps -1 .. 31 give every cell of the band once
    const uint32_t* a_row = s_src + (g + 8) * kHashWords + 2 * tq;  // tile row g
    const uint32_t* b_col = s_dst + (g + 8) * kHashWords + 2 * tq;  // tile column g
    if (warp == kWarps - 1) {
      walk_tile<3>(s_phase, a_row, b_col, 2 * warp, g, tq, c_in);  // 14, 15, 16
    } else {
      walk_tile<2>(s_phase, a_row, b_col, 2 * warp, g, tq, c_in);
    }
    __syncthreads();

    // this diagonal's rows 8s + g, bit s of ph[g], as eight 32-row words
    uint32_t ph[8];
    const uint4* mine = reinterpret_cast<const uint4*>(s_phase + (k + kPad) * 8);
    const uint4 ph_lo = mine[0];
    const uint4 ph_hi = mine[1];
    ph[0] = ph_lo.x; ph[1] = ph_lo.y; ph[2] = ph_lo.z; ph[3] = ph_lo.w;
    ph[4] = ph_hi.x; ph[5] = ph_hi.y; ph[6] = ph_hi.z; ph[7] = ph_hi.w;
    transpose8(ph);  // byte b of ph[i]: rows 64b + 8i .. 64b + 8i + 7
#pragma unroll
    for (int w = 0; w < kRows / 32; ++w) {
      const int b = w >> 1;
      const int i0 = 4 * (w & 1);
      const uint32_t sel = b | ((4 + b) << 4);  // byte b of x, byte b of y
      const uint32_t word = __byte_perm(__byte_perm(ph[i0], ph[i0 + 1], sel),
                                        __byte_perm(ph[i0 + 2], ph[i0 + 3], sel),
                                        0x5410);
      // validity, an explicit predicate: the diagonal's rows in [lo, hi)
      const int r = rs + 32 * w;
      runs_word(word & span_bits(lo - r, hi - r), l_min, run, cand);
    }
  }
  cand += run >= l_min;  // a run live at the last walked row ends there
  const int d = d0 + k;
  if (d < n_out) counts[static_cast<size_t>(p) * n_out + d] = cand;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// All arrays are device pointers: nv, mv, lm, thr (chunk,) int32; bm
// (chunk, n_groups) int32; src, dst (chunk, n_pad) uint32 bit patterns;
// counts (chunk, n_out) int32, written in full. Any n_pad.
extern "C" int needle_diag_runs(const void* nv, const void* mv, const void* lm,
                                const void* thr, const void* bm, int n_groups,
                                const void* src, const void* dst, void* counts,
                                int chunk, int n_pad, int n_out, void* stream) {
  if (chunk == 0 || n_out == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 0 || chunk > 65535 || n_pad <= 0 || n_out < 0 || n_groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + kBand - 1) / kBand, chunk);
  diag_runs_mma_kernel<<<grid, kBand, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(mv),
      static_cast<const int32_t*>(lm), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(bm), n_groups, static_cast<const uint32_t*>(src),
      static_cast<const uint32_t*>(dst), static_cast<int32_t*>(counts), n_pad,
      n_out);
  return static_cast<int>(cudaGetLastError());
}
