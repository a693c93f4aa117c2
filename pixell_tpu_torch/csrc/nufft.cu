// K10 and K11: the point stage of the ES-kernel NUFFT for one Hopper card
// (sm_90a). New kernels of the port: the reference runs this stage in XLA,
// with no pallas_call.
//
// K10 u2nu_points_kernel<T, COMPLEX> is the counterpart of
// pixell_tpu/fft.py _u2nu_2d_core_split (:391) and _u2nu_2d_core (:379):
// each nonuniform point's ES-weighted sum over its w x w window of an
// oversampled fine grid [C, nfy, nfx], real or complex. On the TPU the
// window is fetched by one block gather per point (_block_gather_eval
// :344), in chunks that bound the gathered [chunk, w, w, C] transient; here
// a thread takes one point and reads its window straight from the fine
// grid, through L1 and L2, with no transient.
// K11 nu2u_spread_kernel<T, COMPLEX> is its transpose, the counterpart of
// _nu2u_2d_core (:610): each point adds its value times its window's
// weights onto the fine grid with atomicAdd (float and double atomics are
// native on sm_90), so its sums change order from run to run.
//
// A point's position in fine pixels is p = ((c/per) mod 1) n, computed in
// double whatever T is, and split into floor(p) and the fraction
// f = p - floor(p), cast to T. The taps are the rows (columns)
// floor(p) + floor(f - w/2) + 1 + j, j < w, wrapped periodically, weighted
// by exp(beta (sqrt(1 - z^2) - 1)) at z = (f - (floor(f - w/2) + 1 + j))/(w/2):
// the arithmetic of the plain twins in ops/nufft_core.py, in the same order.
//
// What bounds them: per point 2 w^2 C' operations (C' = C real components,
// 2 C complex) and 2 w ES evaluations, against one pass over the fine grid
// and the coordinates and the output; at the shapes of rotate_alm (16M
// points, an 8064^2 grid, w = 11 in double) the bytes. The design here is
// the simple one: a thread per point, its w x-weights in registers, the
// w rows read in turn (each row's weight computed where it is used), in the order the points come (neighbouring points
// of a ring share rows in L1). Sorting points by tile or staging windows
// in shared memory is left to a later redesign.
//
// The extern "C" entry points launch on the given stream, do not
// synchronize, and return cudaGetLastError(). No --use_fast_math: the
// weights go through exp and sqrt.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;   // threads (points) per block
constexpr int WMAX = 16;     // the largest kernel width (pixell_tpu.fft._es_params)

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }
__device__ __forceinline__ double clamp01(double x) { return fmin(fmax(x, 0.0), 1.0); }

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The ES weight of tap j of a point with fraction f and tf = floor(f - hw).
template <typename T>
__device__ __forceinline__ T es_weight(T f, T tf, int j, T hw, T beta) {
  const T z = (f - (tf + T(1) + (T)j)) / hw;
  const T z2 = clamp01(z * z);
  return abs_t(z) <= T(1) ? exp_t(beta * (sqrt_t(T(1) - z2) - T(1))) : T(0);
}

// A point at coordinate c with period per on an axis of n fine pixels:
// its fraction f and tf = floor(f - w/2); returns its first tap, not yet
// wrapped.
template <typename T>
__device__ __forceinline__ int point_axis(double c, double per, int n, T hw, T& f, T& tf) {
  double t = c / per;
  t = t - floor(t);
  const double p = t * (double)n;
  const double b = floor(p);
  f = (T)(p - b);
  tf = floor_t(f - hw);
  return (int)b + (int)tf + 1;
}

template <typename T, bool COMPLEX>
__global__ void __launch_bounds__(BLOCK)
u2nu_points_kernel(const T* __restrict__ fine, const double* __restrict__ coords,
                   T* __restrict__ out, int C, int nfy, int nfx, long long npt, double pery,
                   double perx, int w, T beta) {
  constexpr int R = COMPLEX ? 2 : 1;
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= npt) return;
  const T hw = (T)w / T(2);
  T fy, ty, fx, tx, wx[WMAX];
  const int iy0 = point_axis<T>(coords[2 * p], pery, nfy, hw, fy, ty);
  const int ix0 = point_axis<T>(coords[2 * p + 1], perx, nfx, hw, fx, tx);
#pragma unroll
  for (int i = 0; i < WMAX; ++i)
    if (i < w) wx[i] = es_weight<T>(fx, tx, i, hw, beta);
  const long long plane = (long long)nfy * nfx;
  for (int c = 0; c < C; ++c) {
    const T* f = fine + (long long)c * plane * R;
    T ar = T(0), ai = T(0);
    // rows in turn (their weight computed where it is used), each row's
    // taps unrolled
#pragma unroll 1
    for (int j = 0; j < w; ++j) {
      const T* row = f + (long long)wrap(iy0 + j, nfy) * nfx * R;
      T sr = T(0), si = T(0);
#pragma unroll
      for (int i = 0; i < WMAX; ++i) {
        if (i < w) {
          const int ix = wrap(ix0 + i, nfx);
          sr += row[R * ix] * wx[i];
          if (COMPLEX) si += row[R * ix + 1] * wx[i];
        }
      }
      const T wy = es_weight<T>(fy, ty, j, hw, beta);
      ar += wy * sr;
      if (COMPLEX) ai += wy * si;
    }
    out[R * ((long long)c * npt + p)] = ar;
    if (COMPLEX) out[R * ((long long)c * npt + p) + 1] = ai;
  }
}

template <typename T, bool COMPLEX>
__global__ void __launch_bounds__(BLOCK)
nu2u_spread_kernel(const T* __restrict__ vals, const double* __restrict__ coords,
                   T* __restrict__ fine, int C, int nfy, int nfx, long long npt, double pery,
                   double perx, int w, T beta) {
  constexpr int R = COMPLEX ? 2 : 1;
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= npt) return;
  const T hw = (T)w / T(2);
  T fy, ty, fx, tx, wx[WMAX];
  const int iy0 = point_axis<T>(coords[2 * p], pery, nfy, hw, fy, ty);
  const int ix0 = point_axis<T>(coords[2 * p + 1], perx, nfx, hw, fx, tx);
#pragma unroll
  for (int i = 0; i < WMAX; ++i)
    if (i < w) wx[i] = es_weight<T>(fx, tx, i, hw, beta);
  const long long plane = (long long)nfy * nfx;
  for (int c = 0; c < C; ++c) {
    const T vr = vals[R * ((long long)c * npt + p)];
    const T vi = COMPLEX ? vals[R * ((long long)c * npt + p) + 1] : T(0);
    T* f = fine + (long long)c * plane * R;
#pragma unroll 1
    for (int j = 0; j < w; ++j) {
      T* row = f + (long long)wrap(iy0 + j, nfy) * nfx * R;
      const T wy = es_weight<T>(fy, ty, j, hw, beta);
      const T ar = vr * wy, ai = vi * wy;
#pragma unroll
      for (int i = 0; i < WMAX; ++i) {
        if (i < w) {
          const int ix = wrap(ix0 + i, nfx);
          atomicAdd(row + R * ix, ar * wx[i]);
          if (COMPLEX) atomicAdd(row + R * ix + 1, ai * wx[i]);
        }
      }
    }
  }
}

template <typename T>
int launch(bool spread, int cplx, const void* in, const void* coords, void* out, int C, int nfy,
           int nfx, long long npt, double pery, double perx, int w, double beta,
           cudaStream_t st) {
  const long long nblocks = (npt + BLOCK - 1) / BLOCK;
  const T* x = static_cast<const T*>(in);
  const double* co = static_cast<const double*>(coords);
  T* y = static_cast<T*>(out);
  const T b = (T)beta;
  if (spread) {
    if (cplx)
      nu2u_spread_kernel<T, true><<<(unsigned)nblocks, BLOCK, 0, st>>>(x, co, y, C, nfy, nfx, npt,
                                                                       pery, perx, w, b);
    else
      nu2u_spread_kernel<T, false><<<(unsigned)nblocks, BLOCK, 0, st>>>(x, co, y, C, nfy, nfx, npt,
                                                                        pery, perx, w, b);
  } else {
    if (cplx)
      u2nu_points_kernel<T, true><<<(unsigned)nblocks, BLOCK, 0, st>>>(x, co, y, C, nfy, nfx, npt,
                                                                       pery, perx, w, b);
    else
      u2nu_points_kernel<T, false><<<(unsigned)nblocks, BLOCK, 0, st>>>(x, co, y, C, nfy, nfx, npt,
                                                                        pery, perx, w, b);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool spread, int f64, int cplx, const void* in, const void* coords, void* out, int C,
             int nfy, int nfx, long long npt, double pery, double perx, int w, double beta,
             void* stream) {
  if (npt <= 0 || C <= 0) return 0;
  if (w < 2 || w > WMAX || w > nfy || w > nfx || (npt + BLOCK - 1) / BLOCK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) return launch<double>(spread, cplx, in, coords, out, C, nfy, nfx, npt, pery, perx, w, beta, st);
  return launch<float>(spread, cplx, in, coords, out, C, nfy, nfx, npt, pery, perx, w, beta, st);
}

}  // namespace

// K10: out[C, npt] (complex: interleaved re, im) from fine[C, nfy, nfx] at
// coords[npt, 2] (double, (y, x) in units of the periods pery, perx).
extern "C" int pt_u2nu_points(int f64, int cplx, const void* fine, const void* coords, void* out,
                              int C, int nfy, int nfx, long long npt, double pery, double perx,
                              int w, double beta, void* stream) {
  return dispatch(false, f64, cplx, fine, coords, out, C, nfy, nfx, npt, pery, perx, w, beta, stream);
}

// K11: adds vals[C, npt] onto fine[C, nfy, nfx], which the caller zeroes.
extern "C" int pt_nu2u_spread(int f64, int cplx, const void* vals, const void* coords, void* fine,
                              int C, int nfy, int nfx, long long npt, double pery, double perx,
                              int w, double beta, void* stream) {
  return dispatch(true, f64, cplx, vals, coords, fine, C, nfy, nfx, npt, pery, perx, w, beta, stream);
}

// The largest kernel width the entry points take.
extern "C" int pt_nufft_wmax() { return WMAX; }
