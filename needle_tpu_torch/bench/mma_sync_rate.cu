// How fast mma.sync.m16n8k32.s8 issues on this card: the first limit of the
// count walk kernel (csrc/diag_runs.cu). A stand-alone program:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o mma_sync_rate needle_tpu_torch/bench/mma_sync_rate.cu && ./mma_sync_rate
//
// Three loops of 8 independent products per iteration, each with the walk's
// constant accumulator input: operands in registers only; B fragments read
// from shared memory as the walk reads them (one 8-byte load a lane); and
// that plus the walk's four funnel shifts of the results. For 1, 2, 4 and 8
// blocks of 256 threads per SM it prints the products per second, per SM
// and clock, and the int8 operations per second (8192 a product).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1, int c_in) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c_in),
        "r"(c_in), "r"(c_in), "r"(c_in));
}

// kMode 0: registers only; 1: B from shared memory; 2: and the shifts.
template <int kMode>
__global__ void __launch_bounds__(256) products(int iters, uint32_t* out) {
  __shared__ __align__(16) uint32_t sm[4096];
  for (int i = threadIdx.x; i < 4096; i += 256) sm[i] = i * 2654435761u;
  __syncthreads();
  const uint32_t a0 = threadIdx.x * 7u, a1 = a0 ^ 5u, a2 = a0 * 3u, a3 = a0 + 11u;
  uint32_t acc[8] = {};
  const int lane = threadIdx.x & 31;
  const uint32_t* base = sm + (lane >> 2) * 8 + 2 * (lane & 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0 = a0 + j, b1 = a1 ^ it;
      if (kMode >= 1) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(base + ((it * 8 + j) & 63) * 64);
        b0 = b.x;
        b1 = b.y;
      }
      int c[4];
      mma(c, a0, a1, a2, a3, b0, b1, -12);
      if (kMode >= 2) {
        for (int e = 0; e < 4; ++e) {
          acc[j] = __funnelshift_l(static_cast<uint32_t>(c[e]), acc[j], 1);
        }
      } else {
        acc[j] += c[0] ^ c[1] ^ c[2] ^ c[3];
      }
    }
  }
  uint32_t r = 0;
  for (int j = 0; j < 8; ++j) r ^= acc[j];
  out[blockIdx.x * 256 + threadIdx.x] = r;
}

template <int kMode>
void run(const char* name, int blocks_per_sm) {
  int n_sm = 0, khz = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int blocks = n_sm * blocks_per_sm;
  const int iters = 4096;
  uint32_t* out = nullptr;
  cudaMalloc(&out, blocks * 256 * sizeof(uint32_t));
  products<kMode><<<blocks, 256>>>(16, out);  // warm-up
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  products<kMode><<<blocks, 256>>>(iters, out);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0;
  cudaEventElapsedTime(&ms, start, end);
  const double n = static_cast<double>(blocks) * 8 * iters * 8;  // warps x iters x 8
  const double rate = n / (ms * 1e-3);
  printf("%s, %d block(s)/SM: %.3f ms, %.4g products/s, %.3f per SM per clock "
         "(%d MHz), %.1f TOP/s\n",
         name, blocks_per_sm, ms, rate, rate / n_sm / (khz * 1e3), khz / 1000,
         rate * 8192 / 1e12);
  cudaFree(out);
}

int main() {
  if (cudaSetDevice(0) != cudaSuccess) {
    fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  for (int bps : {1, 2, 4, 8}) {
    run<0>("registers only     ", bps);
    run<1>("B from shared      ", bps);
    run<2>("B from shared, SHF ", bps);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
