// K9: FMA-peak microbenchmark for one Hopper card (sm_90a).
//
// Replaces the TPU vector-unit ceiling kernel of scripts/vpu_peak.py
// (main :21, pallas_call :58), which ran independent x = x*c + d chains on
// VMEM-resident tiles. Here each thread holds ACC independent chains in
// registers and runs iters steps of acc = fma(acc, c, d) on each: element i
// of the output is the chain applied iters times to element i of the input.
// c and d are runtime arguments and the chains' ends are written out, so
// nothing folds away. Each step is one fused multiply-add (2 operations,
// rounded once); the plain PyTorch twin (ops/fma_peak.py) computes x*c + d,
// which rounds twice.
//
// What bounds it: FP32 (or FP64) FMA issue, 2 * n * iters operations for n
// elements, against 8 n bytes (16 n in double) of traffic. The design keeps
// every operand in registers, gives each thread ACC = 8 independent chains
// to hide the FMA latency, and the caller launches many waves of the
// card's 132 SMs. Used to anchor roofline shares; no SHT path calls it.
//
// The extern "C" entry point launches on the given stream, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // threads per block
constexpr int ACC = 8;      // independent chains per thread

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(BLOCK)
fma_peak_kernel(const T* __restrict__ x, T* __restrict__ out, T c, T d, int iters,
                long long n) {
  const long long base = (long long)blockIdx.x * BLOCK * ACC + threadIdx.x;
  T acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const long long i = base + (long long)a * BLOCK;
    acc[a] = i < n ? x[i] : T(0);
  }
#pragma unroll 4
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int a = 0; a < ACC; ++a) acc[a] = fma_rn(acc[a], c, d);
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const long long i = base + (long long)a * BLOCK;
    if (i < n) out[i] = acc[a];
  }
}

}  // namespace

// out[i] = x[i] after iters steps of x = fma(x, c, d), i < n; f64 selects
// the double instantiation.
extern "C" int pt_fma_peak(int f64, const void* x, void* out, double c, double d,
                           int iters, long long n, void* stream) {
  if (n <= 0) return 0;
  if (iters < 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)BLOCK * ACC;
  const long long nblocks = (n + per_block - 1) / per_block;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    fma_peak_kernel<double><<<(unsigned)nblocks, BLOCK, 0, st>>>(
        static_cast<const double*>(x), static_cast<double*>(out), c, d, iters, n);
  else
    fma_peak_kernel<float><<<(unsigned)nblocks, BLOCK, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), (float)c, (float)d,
        iters, n);
  return (int)cudaGetLastError();
}

// Elements per block, so the host can size a launch in whole waves.
extern "C" int pt_fma_peak_block_elems() { return BLOCK * ACC; }
