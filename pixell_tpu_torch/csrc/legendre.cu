// Hand-written Hopper (sm_90a) kernels for the Legendre stage of the
// spin-0 spherical harmonic transform. Four kernels, one recurrence:
//
//   K1 sym_synthesis   replaces _synthesis_scan_pallas_sym
//                      (pixell_tpu/ops/sht_pallas.py:1686, pallas_call :1755)
//   K2 sym_analysis    replaces _analysis_scan_pallas_sym
//                      (pixell_tpu/ops/sht_pallas.py:1850, pallas_call :1928)
//   K3 full_synthesis  replaces _synthesis_scan_pallas_full
//                      (pixell_tpu/ops/sht_pallas.py:1540, pallas_call :1668)
//   K4 full_analysis   replaces _analysis_scan_pallas_full
//                      (pixell_tpu/ops/sht_pallas.py:1954, pallas_call :2089)
//
// Each is templated on float (S = 60) and double (S = 850). The double
// instantiation of K3/K4 is the near-pole pass that the TPU ran in
// double-single arithmetic; Hopper has native f64, and nvcc's default FMA
// contraction would silently break Dekker double-single sums anyway.
//
// Maths (the plain PyTorch twin is pixell_tpu_torch/ops/sht_core.py):
// the normalized associated Legendre values lambda_lm(theta) obey
//   lambda_l = a_lm ((cos theta) lambda_{l-1} - b_lm lambda_{l-2}),
// seeded with lambda_mm at l = m. The state is held scaled,
// lambda = val * 2^(S*level), and renormalized every 8 l-steps, so
// lambda_mm ~ sin^m(theta) cannot underflow near the poles; only levels 0
// and -1 contribute above 2^-S. cos(theta) comes in two parts (hi + lo)
// for float: a plain f32 cos has ~3e-8 absolute error near the poles, which
// the recurrence amplifies by ~l^2. The coefficients a, b and the seeds are
// tables computed outside with correctly rounded sqrt and divide. Build
// WITHOUT --use_fast_math: approximate sqrt/divide are what broke the TPU
// recurrence.
//
// What bounds these kernels on an H100: FP32 (or FP64) FMA and select work,
// about 15 operations per (l, m, theta) triple, over a triangle of
// ~lmax^2/2 (l, m) pairs per ring; device-memory traffic is O(lmax^2 + nm*nt)
// (the coefficient and alm tables, the seeds, the output), far below it.
// Design: one thread per (m, theta) keeps its recurrence state and its
// accumulators in registers for the whole l-loop, which starts at the
// block's smallest m, so the zero triangle l < m is skipped for free. A
// block covers MY m rows x TX rings; per chunk of LC degrees it stages
// a_lm, b_lm (and for synthesis the alm A[l, m, :]) in shared memory, since
// they are the same for every ring of an m row. Warps never straddle two m
// rows, so the seed branch at l = m is warp-uniform.
//
// Analysis reduces lambda * F over the rings of an m row at every l: a warp
// shuffle butterfly, then the row's warps are summed from shared memory.
// Each block writes one partial per (l, m, c) into its own plane of a
// zero-initialized [planes, nl, nm, C] buffer, looping over the ring tiles
// that belong to that plane; the planes are summed afterwards in a
// deterministic second pass. No atomics: results are reproducible.
//
// Every extern "C" entry point launches on the given stream, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TX = 64;  // rings per m row in a block (two warps)
constexpr int MY = 4;   // m rows per block
constexpr int LC = 32;  // degrees staged in shared memory per chunk
constexpr int NTHREADS = TX * MY;

template <typename T> struct Scale;
template <> struct Scale<float> {
  __device__ static float band() { return 0x1p60f; }
  __device__ static float invband() { return 0x1p-60f; }
};
template <> struct Scale<double> {
  __device__ static double band() { return 0x1p850; }
  __device__ static double invband() { return 0x1p-850; }
};

template <typename T> struct State {
  T prev, curr;
  int lev;
};

// One recurrence step at degree l for row m. Returns the true lambda_lm.
template <typename T>
__device__ __forceinline__ T step(State<T>& s, int l, int m, T a, T b, T x,
                                  T xlo, T seedv, int seedl) {
  T nw = a * ((x * s.curr + xlo * s.curr) - b * s.prev);
  T cz = s.curr;
  if (l == m) {  // seed; the stale previous value has another scale
    nw = seedv;
    s.lev = seedl;
    cz = T(0);
  }
  s.prev = cz;
  s.curr = nw;
  const T fac = s.lev == 0 ? T(1) : (s.lev == -1 ? Scale<T>::invband() : T(0));
  return nw * fac;
}

__device__ __forceinline__ float absval(float v) { return fabsf(v); }
__device__ __forceinline__ double absval(double v) { return fabs(v); }

template <typename T>
__device__ __forceinline__ void rescale(State<T>& s) {
  if (absval(s.curr) > Scale<T>::band()) {
    s.prev *= Scale<T>::invband();
    s.curr *= Scale<T>::invband();
    s.lev += 1;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage a_lm, b_lm (and A[l, m, :] when A is given) for degrees
// l0 .. l0+LC-1 and the block's m rows; zero outside the table.
template <typename T, int C>
__device__ __forceinline__ void stage(const T* __restrict__ ab,
                                      const T* __restrict__ A, T (*sa)[MY],
                                      T (*sb)[MY], T (*sA)[MY][C], int l0,
                                      int m0, int nl, int nm, int tid) {
  for (int i = tid; i < LC * MY; i += NTHREADS) {
    const int li = i / MY, mi = i % MY, l = l0 + li, mm = m0 + mi;
    const bool ok = l < nl && mm < nm;
    const size_t lm = (size_t)l * nm + mm;
    sa[li][mi] = ok ? ab[lm] : T(0);
    sb[li][mi] = ok ? ab[(size_t)nl * nm + lm] : T(0);
    if (A != nullptr) {
#pragma unroll
      for (int c = 0; c < C; ++c) sA[li][mi][c] = ok ? A[lm * C + c] : T(0);
    }
  }
}

// K1 (SYM) / K3: G[c, m, t] = sum_l lambda_lm(theta_t) A[l, m, c].
// A [nl, nm, C]; ab [2, nl, nm]; cth, ctl [nt]; sv, sl [nm, nt].
// Full: out [C, nm, nt]. SYM: theta holds the northern rings of a
// south-symmetric ring set and out is [C, 2, nm, nt] with plane 1 the mirror
// ring, from lambda_lm(pi - theta) = (-1)^(l+m) lambda_lm(theta).
template <typename T, int C, bool SYM>
__global__ void __launch_bounds__(NTHREADS)
synthesis_kernel(const T* __restrict__ A, const T* __restrict__ ab,
                 const T* __restrict__ cth, const T* __restrict__ ctl,
                 const T* __restrict__ sv, const int* __restrict__ sl,
                 T* __restrict__ out, int nl, int nm, int nt) {
  __shared__ T sa[LC][MY];
  __shared__ T sb[LC][MY];
  __shared__ T sA[LC][MY][C];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int t = blockIdx.x * TX + tx;
  const int m0 = blockIdx.y * MY, m = m0 + ty;
  const bool valid = t < nt && m < nm;
  const size_t mt = (size_t)m * nt + t;
  const T x = valid ? cth[t] : T(0);
  const T xlo = valid ? ctl[t] : T(0);
  const T seedv = valid ? sv[mt] : T(0);
  const int seedl = valid ? sl[mt] : 0;
  State<T> s{T(0), T(0), 0};
  T accN[C], accS[C];
#pragma unroll
  for (int c = 0; c < C; ++c) accN[c] = accS[c] = T(0);
  for (int l0 = m0; l0 < nl; l0 += LC) {
    __syncthreads();
    stage<T, C>(ab, A, sa, sb, sA, l0, m0, nl, nm, tid);
    __syncthreads();
    const int n = min(LC, nl - l0);
    for (int i = 0; i < n; ++i) {
      const int l = l0 + i;
      const T lam = step(s, l, m, sa[i][ty], sb[i][ty], x, xlo, seedv, seedl);
      const bool odd = (l + m) & 1;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T v = lam * sA[i][ty][c];
        accN[c] += v;
        if (SYM) accS[c] += odd ? -v : v;
      }
      if ((l & 7) == 7) rescale(s);
    }
  }
  if (!valid) return;
  const size_t plane = (size_t)nm * nt;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (SYM) {
      out[(size_t)(2 * c) * plane + mt] = accN[c];
      out[(size_t)(2 * c + 1) * plane + mt] = accS[c];
    } else {
      out[(size_t)c * plane + mt] = accN[c];
    }
  }
}

// K2 (SYM) / K4: part[g, l, m, c] += sum over the rings t of the tiles of
// plane g of lambda_lm(theta_t) F[c, m, t]. Full: F [C, nm, nt]. SYM: F is
// [C, 2, nm, nt] with the even (north + south) and odd (north - south)
// combinations on the northern rings; (l, m) takes the even plane when
// l + m is even. part [gridDim.x, nl, nm, C] must be zero on entry.
template <typename T, int C, bool SYM>
__global__ void __launch_bounds__(NTHREADS)
analysis_kernel(const T* __restrict__ F, const T* __restrict__ ab,
                const T* __restrict__ cth, const T* __restrict__ ctl,
                const T* __restrict__ sv, const int* __restrict__ sl,
                T* __restrict__ part, int nl, int nm, int nt, int ntiles) {
  constexpr int NW = NTHREADS / 32;  // warps per block
  constexpr int WPR = TX / 32;       // warps per m row
  __shared__ T sa[LC][MY];
  __shared__ T sb[LC][MY];
  __shared__ T red[NW][LC][C];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MY, m = m0 + ty;
  const size_t plane = (size_t)nm * nt;
  T* __restrict__ dst = part + (size_t)blockIdx.x * nl * nm * C;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int t = tile * TX + tx;
    const bool valid = t < nt && m < nm;
    const size_t mt = (size_t)m * nt + t;
    const T x = valid ? cth[t] : T(0);
    const T xlo = valid ? ctl[t] : T(0);
    const T seedv = valid ? sv[mt] : T(0);
    const int seedl = valid ? sl[mt] : 0;
    T fE[C], fO[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (SYM) {
        fE[c] = valid ? F[(size_t)(2 * c) * plane + mt] : T(0);
        fO[c] = valid ? F[(size_t)(2 * c + 1) * plane + mt] : T(0);
      } else {
        fE[c] = valid ? F[(size_t)c * plane + mt] : T(0);
        fO[c] = fE[c];
      }
    }
    State<T> s{T(0), T(0), 0};
    for (int l0 = m0; l0 < nl; l0 += LC) {
      __syncthreads();
      stage<T, C>(ab, nullptr, sa, sb, nullptr, l0, m0, nl, nm, tid);
      __syncthreads();
      const int n = min(LC, nl - l0);
      for (int i = 0; i < n; ++i) {
        const int l = l0 + i;
        const T lam = step(s, l, m, sa[i][ty], sb[i][ty], x, xlo, seedv, seedl);
        const bool odd = (l + m) & 1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T v = warp_sum(lam * (odd ? fO[c] : fE[c]));
          if (lane == 0) red[warp][i][c] = v;
        }
        if ((l & 7) == 7) rescale(s);
      }
      __syncthreads();
      // sum the warps of each m row; the same thread owns the same
      // (l, m, c) entry in every tile, so the += needs no atomics
      for (int i = tid; i < n * MY * C; i += NTHREADS) {
        const int li = i / (MY * C), r = i % (MY * C), mi = r / C, c = r % C;
        const int mm = m0 + mi;
        if (mm >= nm) continue;
        T v = T(0);
#pragma unroll
        for (int w = 0; w < WPR; ++w) v += red[mi * WPR + w][li][c];
        dst[((size_t)(l0 + li) * nm + mm) * C + c] += v;
      }
    }
  }
}

template <typename T, bool SYM>
int launch_synthesis(int C, const void* A, const void* ab, const void* cth,
                     const void* ctl, const void* sv, const void* sl, void* out,
                     int nl, int nm, int nt, cudaStream_t st) {
  const dim3 block(TX, MY), grid((nt + TX - 1) / TX, (nm + MY - 1) / MY);
  if (grid.x == 0 || grid.y == 0 || nl == 0) return 0;
  const T* a = static_cast<const T*>(A);
  const T* t = static_cast<const T*>(ab);
  const T* h = static_cast<const T*>(cth);
  const T* lo = static_cast<const T*>(ctl);
  const T* v = static_cast<const T*>(sv);
  const int* lv = static_cast<const int*>(sl);
  T* o = static_cast<T*>(out);
  switch (C) {
    case 1:
      synthesis_kernel<T, 1, SYM><<<grid, block, 0, st>>>(a, t, h, lo, v, lv, o, nl, nm, nt);
      break;
    case 2:
      synthesis_kernel<T, 2, SYM><<<grid, block, 0, st>>>(a, t, h, lo, v, lv, o, nl, nm, nt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool SYM>
int launch_analysis(int C, const void* F, const void* ab, const void* cth,
                    const void* ctl, const void* sv, const void* sl, void* part,
                    int nl, int nm, int nt, int nplanes, cudaStream_t st) {
  const int ntiles = (nt + TX - 1) / TX;
  const dim3 block(TX, MY), grid(nplanes, (nm + MY - 1) / MY);
  if (ntiles == 0 || grid.y == 0 || nl == 0) return 0;
  if (nplanes < 1 || nplanes > ntiles) return (int)cudaErrorInvalidValue;
  const T* f = static_cast<const T*>(F);
  const T* t = static_cast<const T*>(ab);
  const T* h = static_cast<const T*>(cth);
  const T* lo = static_cast<const T*>(ctl);
  const T* v = static_cast<const T*>(sv);
  const int* lv = static_cast<const int*>(sl);
  T* p = static_cast<T*>(part);
  switch (C) {
    case 1:
      analysis_kernel<T, 1, SYM><<<grid, block, 0, st>>>(f, t, h, lo, v, lv, p, nl, nm, nt, ntiles);
      break;
    case 2:
      analysis_kernel<T, 2, SYM><<<grid, block, 0, st>>>(f, t, h, lo, v, lv, p, nl, nm, nt, ntiles);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f64 selects the double instantiation; C (1 or 2) is the coefficient count.
#define SYNTH_ENTRY(NAME, SYM)                                                 \
  extern "C" int NAME(int f64, int C, const void* A, const void* ab,           \
                      const void* cth, const void* ctl, const void* sv,        \
                      const void* sl, void* out, int nl, int nm, int nt,       \
                      void* stream) {                                          \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                       \
    return f64 ? launch_synthesis<double, SYM>(C, A, ab, cth, ctl, sv, sl, out, \
                                               nl, nm, nt, st)                 \
               : launch_synthesis<float, SYM>(C, A, ab, cth, ctl, sv, sl, out,  \
                                              nl, nm, nt, st);                 \
  }

#define ANAL_ENTRY(NAME, SYM)                                                  \
  extern "C" int NAME(int f64, int C, const void* F, const void* ab,           \
                      const void* cth, const void* ctl, const void* sv,        \
                      const void* sl, void* part, int nl, int nm, int nt,      \
                      int nplanes, void* stream) {                             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                       \
    return f64 ? launch_analysis<double, SYM>(C, F, ab, cth, ctl, sv, sl, part, \
                                              nl, nm, nt, nplanes, st)         \
               : launch_analysis<float, SYM>(C, F, ab, cth, ctl, sv, sl, part,  \
                                             nl, nm, nt, nplanes, st);         \
  }

SYNTH_ENTRY(pt_sym_synthesis, true)
SYNTH_ENTRY(pt_full_synthesis, false)
ANAL_ENTRY(pt_sym_analysis, true)
ANAL_ENTRY(pt_full_analysis, false)

// Kernel tile sizes, so the host can size the partial planes.
extern "C" int pt_tile_theta() { return TX; }
