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
// and the count in registers; one block covers 256 diagonals of one pair.
// The pair's src and dst rows are staged once per block in shared memory
// (8 * n_pad bytes: 20 KB at n_pad 2560; above 48 KB the launch opts in to
// more, up to 227 KB). Neighbouring threads read neighbouring dst words
// (no bank conflicts) and src[i] is a broadcast.
//
// Bound. A pair costs about nv * mv cell steps (each diagonal walks only its
// valid rows), each a few integer instructions and two shared-memory loads:
// the walk is bound by integer issue and shared-memory load throughput, not
// by device memory, which sees only the two hash rows in and one count row
// out per block.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kDTile = 512;    // diagonals per tile, and rows per mask block
constexpr int kGTiles = 8;     // tiles per mask group
constexpr int kThreads = 256;  // diagonals per thread block
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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// All arrays are device pointers: nv, mv, lm, thr (chunk,) int32; bm
// (chunk, n_groups) int32; src, dst (chunk, n_pad) uint32 bit patterns;
// counts (chunk, n_out) int32, written in full.
extern "C" int needle_diag_runs(const void* nv, const void* mv, const void* lm,
                                const void* thr, const void* bm, int n_groups,
                                const void* src, const void* dst, void* counts,
                                int chunk, int n_pad, int n_out,
                                void* stream) {
  if (chunk == 0 || n_out == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 0 || chunk > 65535 || n_pad <= 0 || n_out < 0 || n_groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(n_pad) * sizeof(uint32_t);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_out + kThreads - 1) / kThreads, chunk);
  diag_runs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(mv),
      static_cast<const int32_t*>(lm), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(bm), n_groups,
      static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(dst),
      static_cast<int32_t*>(counts), n_pad, n_out);
  return static_cast<int>(cudaGetLastError());
}
