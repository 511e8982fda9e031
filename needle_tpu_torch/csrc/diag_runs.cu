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
// Design. One thread per diagonal walks i in order and keeps the run length
// and the count in registers; one block covers 256 diagonals of one pair,
// all in one mask group (4096 / 256 blocks per group). Two stagings of the
// pair's hash rows in shared memory, chosen by the caller:
//
//   - whole rows (diag_runs_kernel): src and dst are staged once per block,
//     8 * n_pad bytes (20 KB at n_pad 2560; above 48 KB the launch opts in
//     to more). Fits up to n_pad 29,056 (227 KB).
//   - per row block (diag_runs_blocked_kernel), for any n_pad: before the
//     block walks row block b it stages the 512 src words of b and the
//     512 + 255 dst words its 256 diagonals read there, about 5 KB. A row
//     block whose mask bit is clear (the bit is the same for every thread
//     of the block) is neither staged nor walked.
//
// In both, neighbouring threads read neighbouring dst words (no bank
// conflicts) and src[i] is a broadcast.
//
// Bound. A pair costs about nv * mv cell steps (each diagonal walks only its
// valid rows), each a few integer instructions and two shared-memory loads:
// the walk is bound by integer issue and shared-memory load throughput, not
// by device memory, which sees the two hash rows in (once per block, or once
// per row block and thread block) and one count row out.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kDTile = 512;    // diagonals per tile, and rows per mask block
constexpr int kGTiles = 8;     // tiles per mask group
constexpr int kThreads = 256;  // diagonals per thread block
constexpr int kStageDst = kDTile + kThreads - 1;  // dst words per row block
constexpr size_t kDefaultSmemBytes = 48 * 1024;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB opt-in limit on sm_90

__global__ void __launch_bounds__(kThreads)
diag_runs_kernel(const int32_t* __restrict__ nv, const int32_t* __restrict__ mv,
                 const int32_t* __restrict__ lm, const int32_t* __restrict__ thr,
                 const int32_t* __restrict__ bm, int n_groups,
                 const uint32_t* __restrict__ src,
                 const uint32_t* __restrict__ dst,
                 int32_t* __restrict__ counts, int n_pad, int n_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_src = smem;
  uint32_t* s_dst = smem + n_pad;
  const int p = blockIdx.y;
  const uint32_t* g_src = src + static_cast<size_t>(p) * n_pad;
  const uint32_t* g_dst = dst + static_cast<size_t>(p) * n_pad;
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    s_src[k] = g_src[k];
    s_dst[k] = g_dst[k];
  }
  __syncthreads();

  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= n_out) return;
  const int o = d - (n_pad - 1);
  int cand = 0;
  if (d < 2 * n_pad - 1) {
    const int l_min = max(lm[p], 1);
    const int t = thr[p];
    // arithmetic shift of a signed mask: -1 (every block) reads 1 at bit 31
    const int bits =
        bm[static_cast<size_t>(p) * n_groups + d / (kGTiles * kDTile)];
    const int lo = max(1, 1 - o);
    const int hi = min(min(nv[p], n_pad), min(mv[p], n_pad) - o);  // exclusive
    int run = 0;
    if (lo < hi) {
      for (int b = (lo + 1) / kDTile; b <= hi / kDTile; ++b) {
        if (((bits >> min(b, 31)) & 1) == 0) {
          cand += run >= l_min;  // flush the carry at the gap
          run = 0;
          continue;
        }
        const int r0 = max(lo, b * kDTile - 1);
        const int r1 = min(hi, (b + 1) * kDTile - 1);
        for (int i = r0; i < r1; ++i) {
          const bool match = __popc(s_src[i] ^ s_dst[i + o]) <= t;
          cand += (!match) & (run >= l_min);
          run = match ? run + 1 : 0;
        }
      }
      cand += run >= l_min;  // a run live at the last valid row ends there
    }
  }
  counts[static_cast<size_t>(p) * n_out + d] = cand;
}

__global__ void __launch_bounds__(kThreads)
diag_runs_blocked_kernel(const int32_t* __restrict__ nv,
                         const int32_t* __restrict__ mv,
                         const int32_t* __restrict__ lm,
                         const int32_t* __restrict__ thr,
                         const int32_t* __restrict__ bm, int n_groups,
                         const uint32_t* __restrict__ src,
                         const uint32_t* __restrict__ dst,
                         int32_t* __restrict__ counts, int n_pad, int n_out) {
  __shared__ uint32_t s_src[kDTile];
  __shared__ uint32_t s_dst[kStageDst];
  const int p = blockIdx.y;
  const uint32_t* g_src = src + static_cast<size_t>(p) * n_pad;
  const uint32_t* g_dst = dst + static_cast<size_t>(p) * n_pad;
  const int n_diag = 2 * n_pad - 1;
  const int nv_p = min(nv[p], n_pad);
  const int mv_p = min(mv[p], n_pad);
  const int l_min = max(lm[p], 1);
  const int t = thr[p];
  const int d0 = blockIdx.x * kThreads;
  // one mask group per thread block, so every thread reads the same bits
  const int bits = bm[static_cast<size_t>(p) * n_groups + d0 / (kGTiles * kDTile)];

  // this thread's diagonal and its valid rows [lo, hi)
  const int d = d0 + threadIdx.x;
  const int o = d - (n_pad - 1);
  const int lo = max(1, 1 - o);
  const int hi = min(nv_p, mv_p - o);
  const bool live = d < n_diag && lo < hi;
  // rows that any diagonal of the block walks: lo falls and hi falls as o
  // grows, so the union is [lo(last o), hi(first o))
  const int o0 = d0 - (n_pad - 1);
  const int o_last = min(d0 + kThreads, n_diag) - 1 - (n_pad - 1);
  const int lo_u = max(1, 1 - o_last);
  const int hi_u = min(nv_p, mv_p - o0);

  int run = 0;
  int cand = 0;
  // control flow of this loop is uniform across the block (lo_u, hi_u and
  // bits are), so the barriers inside are reached by every thread
  for (int b = (lo_u + 1) / kDTile; lo_u < hi_u && b <= hi_u / kDTile; ++b) {
    const bool mine = live && b >= (lo + 1) / kDTile && b <= hi / kDTile;
    if (((bits >> min(b, 31)) & 1) == 0) {
      if (mine) {
        cand += run >= l_min;  // flush the carry at the gap
        run = 0;
      }
      continue;
    }
    const int rb = b * kDTile - 1;  // first row of block b
    __syncthreads();  // every thread is done with the previous row block
    for (int k = threadIdx.x; k < kDTile; k += kThreads) {
      const int i = rb + k;
      s_src[k] = (i >= 0 && i < n_pad) ? g_src[i] : 0u;
    }
    for (int k = threadIdx.x; k < kStageDst; k += kThreads) {
      const int j = rb + o0 + k;
      s_dst[k] = (j >= 0 && j < n_pad) ? g_dst[j] : 0u;
    }
    __syncthreads();
    if (mine) {
      // row i of diagonal o reads dst[i + o] = s_dst[i - rb + threadIdx.x]
      const int r0 = max(lo, rb);
      const int r1 = min(hi, rb + kDTile);
      for (int i = r0; i < r1; ++i) {
        const bool match =
            __popc(s_src[i - rb] ^ s_dst[i - rb + threadIdx.x]) <= t;
        cand += (!match) & (run >= l_min);
        run = match ? run + 1 : 0;
      }
    }
  }
  if (live) cand += run >= l_min;  // a run live at the last valid row ends there
  if (d < n_out) counts[static_cast<size_t>(p) * n_out + d] = cand;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// All arrays are device pointers: nv, mv, lm, thr (chunk,) int32; bm
// (chunk, n_groups) int32; src, dst (chunk, n_pad) uint32 bit patterns;
// counts (chunk, n_out) int32, written in full. whole_rows != 0 takes the
// whole-row staging (n_pad <= 29,056), 0 the per-row-block staging.
extern "C" int needle_diag_runs(const void* nv, const void* mv, const void* lm,
                                const void* thr, const void* bm, int n_groups,
                                const void* src, const void* dst, void* counts,
                                int chunk, int n_pad, int n_out, int whole_rows,
                                void* stream) {
  if (chunk == 0 || n_out == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 0 || chunk > 65535 || n_pad <= 0 || n_out < 0 || n_groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + kThreads - 1) / kThreads, chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* nv_ = static_cast<const int32_t*>(nv);
  const int32_t* mv_ = static_cast<const int32_t*>(mv);
  const int32_t* lm_ = static_cast<const int32_t*>(lm);
  const int32_t* thr_ = static_cast<const int32_t*>(thr);
  const int32_t* bm_ = static_cast<const int32_t*>(bm);
  const uint32_t* src_ = static_cast<const uint32_t*>(src);
  const uint32_t* dst_ = static_cast<const uint32_t*>(dst);
  int32_t* counts_ = static_cast<int32_t*>(counts);
  if (!whole_rows) {
    diag_runs_blocked_kernel<<<grid, kThreads, 0, s>>>(
        nv_, mv_, lm_, thr_, bm_, n_groups, src_, dst_, counts_, n_pad, n_out);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 2 * static_cast<size_t>(n_pad) * sizeof(uint32_t);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  diag_runs_kernel<<<grid, kThreads, smem, s>>>(
      nv_, mv_, lm_, thr_, bm_, n_groups, src_, dst_, counts_, n_pad, n_out);
  return static_cast<int>(cudaGetLastError());
}
