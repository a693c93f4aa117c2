// K10, K11 and K12: the point stage of the ES-kernel NUFFT for one Hopper
// card (sm_90a). New kernels of the port: the reference runs this stage in
// XLA, with no pallas_call. K12 tile_keys_kernel<T, K> keys each point by
// the fine-grid tile of its first tap, for the binning K10 and K11 take.
//
// K10 u2nu_points_kernel<T, COMPLEX> is the counterpart of
// pixell_tpu/fft.py _u2nu_2d_core_split (:391) and _u2nu_2d_core (:379):
// each nonuniform point's ES-weighted sum over its w x w window of an
// oversampled fine grid [C, nfy, nfx], real or complex. On the TPU the
// window is fetched by one block gather per point (_block_gather_eval
// :344), in chunks that bound the gathered [chunk, w, w, C] transient.
// K11 nu2u_spread_kernel<T, COMPLEX> is its transpose, the counterpart of
// _nu2u_2d_core (:610): each point adds its value times its window's
// weights onto the fine grid.
//
// A point's position in fine pixels is p = ((c/per) mod 1) n, computed in
// double whatever T is, and split into floor(p) and the fraction
// f = p - floor(p), cast to T. The taps are the rows (columns)
// floor(p) + floor(f - w/2) + 1 + j, j < w, wrapped periodically, weighted
// by exp(beta (sqrt(1 - z^2) - 1)) at z = (f - (floor(f - w/2) + 1 + j))/(w/2):
// the arithmetic of the plain twins in ops/nufft_core.py, in the same order.
//
// The points come binned (ops/nufft_core.py bin_points on the keys of K12
// tile_keys_kernel, below): sorted by the tile of Ty x Tx fine cells that
// holds their first tap, and each tile's points cut into subproblems of at
// most cap. A block takes one subproblem. The padded tile, (Ty + w - 1) x
// (Tx + w - 1) cells from the tile's corner, wrapped, holds every tap of
// every point of the tile, so a block works in shared memory:
//
// - K10 copies the padded tile of cc components from the fine grid into
//   shared memory with cp.async (a warp a row, lanes along it, the periodic
//   wrap at the grid's seams, one wait for all), then a thread takes a
//   point and sums its window there in the order of the first design: rows
//   in turn, each row's taps in x, each row's weight computed once for all
//   the components. The results are those of a thread reading the fine
//   grid, bit for bit, and free of atomics, so the same from run to run.
// - K11 accumulates its points' contributions in shared memory and adds the
//   padded tile onto the fine grid once, one atomicAdd per cell that holds
//   a nonzero sum (several subproblems share a tile, and neighbouring padded
//   tiles overlap; a padded tile that wraps onto itself on a grid smaller
//   than it adds each of its cells): 1764 global atomics per subproblem at
//   w = 11 and 32 x 32 tiles, where the first design issued one per point,
//   tap and component (121 at w = 11). The additions in shared memory take
//   no atomics: atomicAdd on a shared float or double compiles to a
//   compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN, chip_smoke.py's SASS
//   check), whose retries would pile up at the pulled-back poles where
//   thousands of points share a cell. Instead a block is one warp, which
//   takes one point at a time, its lanes on distinct taps (tap k = lane +
//   32 r, r < ceil(w^2/32)), so no two lanes touch one cell and a plain
//   load-add-store is safe. Before that the lanes compute the ES weights of
//   32 points at once, a point a lane, into shared buffers. With one warp a
//   block no warp waits at a block's barrier for another's points.
//
// The components go through the padded tile cc at a time, cc chosen by the
// wrapper from the shared-memory size (smem_bytes, pt_nufft_smem_bytes). A
// point whose first tap lies outside its subproblem's tile traps: it cannot
// occur with K12's keys, which place the first tap with the same
// point_axis.
//
// What bounds them on this card: per point 2 w^2 C' operations (C' = C
// real components, 2 C complex) and 2 w ES weights, each an IEEE division,
// a sqrt and an exp (the bounds count 8 operations a weight). Each weight
// is a chain of dependent operations a thread cannot overlap: in K10 the
// weights are a large share of the time. K11's taps are
// latency-bound: per point a round of shared loads, the adds, the stores
// and the warp's barrier before the next point, whose window may overlap.
//
// The extern "C" entry points launch on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError(). No
// --use_fast_math: the weights go through exp and sqrt.

#include <cuda_runtime.h>

namespace {

constexpr int POINT_BLOCK = 128;  // K10: threads (points at a time) per block
constexpr int POINT_CMAX = 4;     // K10: the most components a block takes at a time
constexpr int KEY_BLOCK = 256;    // K12: threads (points) per block
constexpr int WMAX = 16;          // the largest kernel width (pixell_tpu.fft._es_params)
constexpr int LANES = 33;         // K11's weight buffers: a row per weight, a column per lane
constexpr int SMEM_MAX = 232448;  // shared memory a block may have on sm_90

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

// i >= 0 modulo n, for the padded tile's rows and columns: i < 2n unless
// the grid is smaller than the padded tile.
__device__ __forceinline__ int wrap_up(int i, int n) {
  return i < n ? i : (i < 2 * n ? i - n : i % n);
}

// The ES weight of tap j of a point with fraction f and tf = floor(f - hw).
template <typename T>
__device__ __forceinline__ T es_weight(T f, T tf, int j, T hw, T beta) {
  const T z = (f - (tf + T(1) + (T)j)) / hw;
  const T z2 = clamp01(z * z);
  return abs_t(z) <= T(1) ? exp_t(beta * (sqrt_t(T(1) - z2) - T(1))) : T(0);
}

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// A point at coordinate c with period per on an axis of n fine pixels:
// its fraction f and tf = floor(f - w/2); returns its first tap, not yet
// wrapped. Each operation rounded on its own (no contraction into an FMA;
// the division is IEEE), as the twins' torch operations are, so that K12
// and K10 / K11 place every first tap alike.
template <typename T>
__device__ __forceinline__ int point_axis(double c, double per, int n, T hw, T& f, T& tf) {
  double t = c / per;
  t = __dsub_rn(t, floor(t));
  const double p = __dmul_rn(t, (double)n);
  const double b = floor(p);
  f = (T)__dsub_rn(p, b);
  tf = floor_t(sub_rn(f, hw));
  return (int)b + (int)tf + 1;
}

// An asynchronous copy of BYTES (4, 8 or 16) from global to shared memory,
// and the wait for all of a thread's copies.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A subproblem: its points perm[start:end], its tile's corner (y0, x0).
struct Sub {
  long long start, end;
  int y0, x0;
};

__device__ __forceinline__ Sub load_sub(const long long* subs, int ty, int tx, int ntx) {
  const long long* s = subs + 3 * (long long)blockIdx.x;
  const int t = (int)s[0];
  return {s[1], s[2], (t / ntx) * ty, (t % ntx) * tx};
}

// (at least four blocks an SM: with the thread count alone ptxas picks
// fewer registers and spills)
template <typename T, bool COMPLEX>
__global__ void __launch_bounds__(POINT_BLOCK, 4)
u2nu_points_kernel(const T* __restrict__ fine, const double* __restrict__ coords,
                   const long long* __restrict__ perm, const long long* __restrict__ subs,
                   T* __restrict__ out, int C, int cc, int nfy, int nfx, long long npt,
                   double pery, double perx, int w, T beta, int ty, int tx, int ntx) {
  constexpr int R = COMPLEX ? 2 : 1;
  extern __shared__ __align__(16) unsigned char nufft_smem[];
  T* tile = reinterpret_cast<T*>(nufft_smem);   // [cc][ph][pw][R]
  const Sub sub = load_sub(subs, ty, tx, ntx);
  if (sub.start >= sub.end) return;
  const int ph = ty + w - 1, pw = tx + w - 1, cells = ph * pw;
  const T hw = (T)w / T(2);
  const long long plane = (long long)nfy * nfx;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int nc = min(cc, C - c0);
    if (c0 > 0) __syncthreads();   // the last components' reads done
    // the copies all issued before one wait: a warp a row, its lanes along
    // the row
    for (int cr = threadIdx.x / 32; cr < nc * ph; cr += POINT_BLOCK / 32) {
      const int c = cr / ph, r = cr - c * ph;
      const T* src = fine + ((long long)(c0 + c) * plane + (long long)wrap_up(sub.y0 + r, nfy) * nfx) * R;
      T* dst = tile + R * (c * cells + r * pw);
      for (int q = threadIdx.x % 32; q < pw; q += 32)
        cp_async<R * sizeof(T)>(dst + R * q, src + R * wrap_up(sub.x0 + q, nfx));
    }
    cp_async_wait_all();
    __syncthreads();
    for (long long k = sub.start + threadIdx.x; k < sub.end; k += POINT_BLOCK) {
      const long long p = perm[k];
      T fy, tyf, fx, txf, wx[WMAX];
      const int iy0 = point_axis<T>(coords[2 * p], pery, nfy, hw, fy, tyf);
      const int ix0 = point_axis<T>(coords[2 * p + 1], perx, nfx, hw, fx, txf);
#pragma unroll
      for (int i = 0; i < WMAX; ++i)
        if (i < w) wx[i] = es_weight<T>(fx, txf, i, hw, beta);
      const int ly = wrap(iy0, nfy) - sub.y0, lx = wrap(ix0, nfx) - sub.x0;
      if (ly < 0 || ly >= ty || lx < 0 || lx >= tx) __trap();   // not binned by tile_keys
      const T* base = tile + R * (ly * pw + lx);
      T ar[POINT_CMAX], ai[POINT_CMAX];
#pragma unroll
      for (int c = 0; c < POINT_CMAX; ++c) ar[c] = ai[c] = T(0);
      // rows in turn, each row's weight computed once for the components and
      // each component's row taps unrolled
#pragma unroll 1
      for (int j = 0; j < w; ++j) {
        const T wy = es_weight<T>(fy, tyf, j, hw, beta);
#pragma unroll
        for (int c = 0; c < POINT_CMAX; ++c) {
          if (c < nc) {
            const T* row = base + R * (c * cells + j * pw);
            T sr = T(0), si = T(0);
#pragma unroll
            for (int i = 0; i < WMAX; ++i) {
              if (i < w) {
                sr += row[R * i] * wx[i];
                if (COMPLEX) si += row[R * i + 1] * wx[i];
              }
            }
            ar[c] += wy * sr;
            if (COMPLEX) ai[c] += wy * si;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < POINT_CMAX; ++c) {
        if (c < nc) {
          out[R * ((long long)(c0 + c) * npt + p)] = ar[c];
          if (COMPLEX) out[R * ((long long)(c0 + c) * npt + p) + 1] = ai[c];
        }
      }
    }
  }
}

// (one warp a block; four blocks an SM, as SPREAD_SMEM in ops/nufft_cuda.py
// sizes their shared memory)
template <typename T, bool COMPLEX>
__global__ void __launch_bounds__(32, 4)
nu2u_spread_kernel(const T* __restrict__ vals, const double* __restrict__ coords,
                   const long long* __restrict__ perm, const long long* __restrict__ subs,
                   T* __restrict__ fine, int C, int cc, int nfy, int nfx, long long npt,
                   double pery, double perx, int w, T beta, int ty, int tx, int ntx) {
  constexpr int R = COMPLEX ? 2 : 1;
  extern __shared__ __align__(16) unsigned char nufft_smem[];
  const Sub sub = load_sub(subs, ty, tx, ntx);
  if (sub.start >= sub.end) return;
  const int lane = threadIdx.x;
  const int ph = ty + w - 1, pw = tx + w - 1, cells = ph * pw;
  // the padded tile [cc][cells][R], the weights wb[2w][LANES] (rows y then
  // x) and the values vb[cc R][LANES] of a batch of 32 points, and the
  // batch's 32 tile offsets
  T* const tile = reinterpret_cast<T*>(nufft_smem);
  T* const wb = tile + cc * cells * R;
  T* const vb = wb + 2 * w * LANES;
  int* const offs = reinterpret_cast<int*>(vb + cc * R * LANES);
  const T hw = (T)w / T(2);
  const long long plane = (long long)nfy * nfx;
  // the lane's taps, tap k = lane + 32 r < w^2 (bit r of live): its
  // weights' rows in wb and its cell's offset in the tile
  int live = 0, wyo[8], wxo[8], toff[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = lane + 32 * r, j = k / w, i = k - j * w;
    if (k < w * w) live |= 1 << r;
    wyo[r] = j * LANES;
    wxo[r] = (w + i) * LANES;
    toff[r] = R * (j * pw + i);
  }
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int nc = min(cc, C - c0);
    for (int e = lane; e < nc * cells * R; e += 32) tile[e] = T(0);
    __syncwarp();
    for (long long q0 = sub.start; q0 < sub.end; q0 += 32) {
      // the batch's weights and values, a point a lane
      const long long k = q0 + lane;
      int off = 0;
      if (k < sub.end) {
        const long long p = perm[k];
        T fy, tyf, fx, txf;
        const int iy0 = point_axis<T>(coords[2 * p], pery, nfy, hw, fy, tyf);
        const int ix0 = point_axis<T>(coords[2 * p + 1], perx, nfx, hw, fx, txf);
        const int ly = wrap(iy0, nfy) - sub.y0, lx = wrap(ix0, nfx) - sub.x0;
        if (ly < 0 || ly >= ty || lx < 0 || lx >= tx) __trap();   // not binned by tile_keys
        for (int j = 0; j < w; ++j) wb[j * LANES + lane] = es_weight<T>(fy, tyf, j, hw, beta);
        for (int i = 0; i < w; ++i) wb[(w + i) * LANES + lane] = es_weight<T>(fx, txf, i, hw, beta);
        for (int c = 0; c < nc; ++c) {
          const T* v = vals + R * ((long long)(c0 + c) * npt + p);
          vb[c * R * LANES + lane] = v[0];
          if (COMPLEX) vb[(c * R + 1) * LANES + lane] = v[1];
        }
        off = R * (ly * pw + lx);
      }
      offs[lane] = off;
      __syncwarp();
      // the batch's points in turn, the lanes on distinct taps: each
      // point's weights and cells loaded together, then the cells stored
      const int m = (int)min((long long)32, sub.end - q0);
      for (int q = 0; q < m; ++q) {
        const int o = offs[q];
        T wy[8], wx[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (live >> r & 1) wy[r] = wb[wyo[r] + q], wx[r] = wb[wxo[r] + q];
        for (int c = 0; c < nc; ++c) {
          T* const cell = tile + c * cells * R + o;
          const T vr = vb[c * R * LANES + q];
          const T vi = COMPLEX ? vb[(c * R + 1) * LANES + q] : T(0);
          T sr[8], si[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (live >> r & 1) {
              sr[r] = cell[toff[r]];
              if (COMPLEX) si[r] = cell[toff[r] + 1];
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (live >> r & 1) {
              cell[toff[r]] = sr[r] + vr * wy[r] * wx[r];
              if (COMPLEX) cell[toff[r] + 1] = si[r] + vi * wy[r] * wx[r];
            }
          }
        }
        __syncwarp();   // this point's stores before the next point's loads
      }
      __syncwarp();     // the batch's reads before the next batch's writes
    }
    // the tile onto the fine grid, one atomicAdd per nonzero cell, a row at
    // a time with the lanes along it
    for (int cr = 0; cr < nc * ph; ++cr) {
      const int c = cr / ph, r = cr - c * ph;
      T* const row = fine + ((long long)(c0 + c) * plane + (long long)wrap_up(sub.y0 + r, nfy) * nfx) * R;
      for (int q = lane; q < pw; q += 32) {
        const T* const s = tile + R * (c * cells + r * pw + q);
        T* const dst = row + R * wrap_up(sub.x0 + q, nfx);
        if (s[0] != T(0)) atomicAdd(dst, s[0]);
        if (COMPLEX && s[1] != T(0)) atomicAdd(dst + 1, s[1]);
      }
    }
    __syncwarp();   // the sums read before the next components' zero fill
  }
}

// K12: each point's key for bin_points, the tile (row-major, ty x tx
// cells, ntx a row) that holds its first tap, less offset, placed by
// point_axis: the kernels' own arithmetic, so that every point's taps lie
// in its subproblem's padded tile.
template <typename T, typename K>
__global__ void __launch_bounds__(KEY_BLOCK)
tile_keys_kernel(const double* __restrict__ coords, K* __restrict__ keys, long long npt, int nfy,
                 int nfx, double pery, double perx, int w, int ty, int tx, int ntx, int offset) {
  const long long p = (long long)blockIdx.x * KEY_BLOCK + threadIdx.x;
  if (p >= npt) return;
  const T hw = (T)w / T(2);
  T f, tf;
  const int iy = wrap(point_axis<T>(coords[2 * p], pery, nfy, hw, f, tf), nfy);
  const int ix = wrap(point_axis<T>(coords[2 * p + 1], perx, nfx, hw, f, tf), nfx);
  keys[p] = (K)((iy / ty) * ntx + ix / tx - offset);
}

template <typename T>
int launch_keys(int key_bytes, const void* coords, void* keys, long long npt, int nfy, int nfx,
                double pery, double perx, int w, int ty, int tx, int offset, cudaStream_t st) {
  const int ntx = (nfx + tx - 1) / tx;
  const unsigned nblocks = (unsigned)((npt + KEY_BLOCK - 1) / KEY_BLOCK);
  const double* co = static_cast<const double*>(coords);
  if (key_bytes == 2)
    tile_keys_kernel<T, short><<<nblocks, KEY_BLOCK, 0, st>>>(co, static_cast<short*>(keys), npt, nfy,
                                                              nfx, pery, perx, w, ty, tx, ntx, offset);
  else
    tile_keys_kernel<T, int><<<nblocks, KEY_BLOCK, 0, st>>>(co, static_cast<int*>(keys), npt, nfy, nfx,
                                                            pery, perx, w, ty, tx, ntx, offset);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block: K10 the padded tile of cc components,
// K11 the same with the weight and value buffers and the offsets.
long long smem_bytes(bool spread, int esize, int R, int cc, int w, int ty, int tx) {
  const long long cells = (long long)(ty + w - 1) * (tx + w - 1);
  if (!spread) return cc * cells * R * esize;
  return (cc * cells * R + (2LL * w + (long long)cc * R) * LANES) * esize + 32LL * 4;
}

template <typename T, bool COMPLEX>
int launch_one(bool spread, const void* in, const void* coords, const void* perm, const void* subs,
               long long nsub, void* out, int C, int cc, int nfy, int nfx, long long npt, double pery,
               double perx, int w, double beta, int ty, int tx, cudaStream_t st) {
  const int ntx = (nfx + tx - 1) / tx;
  const long long smem = smem_bytes(spread, (int)sizeof(T), COMPLEX ? 2 : 1, cc, w, ty, tx);
  const T* x = static_cast<const T*>(in);
  const double* co = static_cast<const double*>(coords);
  const long long* pm = static_cast<const long long*>(perm);
  const long long* sb = static_cast<const long long*>(subs);
  T* y = static_cast<T*>(out);
  const T b = (T)beta;
  cudaError_t err;
  if (spread) {
    err = cudaFuncSetAttribute(nu2u_spread_kernel<T, COMPLEX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nu2u_spread_kernel<T, COMPLEX><<<(unsigned)nsub, 32, smem, st>>>(
        x, co, pm, sb, y, C, cc, nfy, nfx, npt, pery, perx, w, b, ty, tx, ntx);
  } else {
    err = cudaFuncSetAttribute(u2nu_points_kernel<T, COMPLEX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    u2nu_points_kernel<T, COMPLEX><<<(unsigned)nsub, POINT_BLOCK, smem, st>>>(
        x, co, pm, sb, y, C, cc, nfy, nfx, npt, pery, perx, w, b, ty, tx, ntx);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool spread, int f64, int cplx, const void* in, const void* coords, const void* perm,
             const void* subs, long long nsub, void* out, int C, int cc, int nfy, int nfx,
             long long npt, double pery, double perx, int w, double beta, int ty, int tx,
             void* stream) {
  if (npt <= 0 || C <= 0 || nsub <= 0) return 0;
  if (w < 2 || w > WMAX || w > nfy || w > nfx || cc < 1 || cc > C || ty < 1 || tx < 1
      || (!spread && cc > POINT_CMAX)
      || nsub > 0x7fffffffLL || smem_bytes(spread, f64 ? 8 : 4, cplx ? 2 : 1, cc, w, ty, tx) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    if (cplx)
      return launch_one<double, true>(spread, in, coords, perm, subs, nsub, out, C, cc, nfy, nfx,
                                      npt, pery, perx, w, beta, ty, tx, st);
    return launch_one<double, false>(spread, in, coords, perm, subs, nsub, out, C, cc, nfy, nfx,
                                     npt, pery, perx, w, beta, ty, tx, st);
  }
  if (cplx)
    return launch_one<float, true>(spread, in, coords, perm, subs, nsub, out, C, cc, nfy, nfx, npt,
                                   pery, perx, w, beta, ty, tx, st);
  return launch_one<float, false>(spread, in, coords, perm, subs, nsub, out, C, cc, nfy, nfx, npt,
                                  pery, perx, w, beta, ty, tx, st);
}

}  // namespace

// K10: out[C, npt] (complex: interleaved re, im) from fine[C, nfy, nfx] at
// coords[npt, 2] (double, (y, x) in units of the periods pery, perx), the
// points binned into nsub subproblems (perm [npt], subs [nsub, 3] int64;
// ops/nufft_core.py bin_points) of ty x tx tiles, cc components at a time.
extern "C" int pt_u2nu_points(int f64, int cplx, const void* fine, const void* coords,
                              const void* perm, const void* subs, long long nsub, void* out, int C,
                              int cc, int nfy, int nfx, long long npt, double pery, double perx,
                              int w, double beta, int ty, int tx, void* stream) {
  return dispatch(false, f64, cplx, fine, coords, perm, subs, nsub, out, C, cc, nfy, nfx, npt, pery,
                  perx, w, beta, ty, tx, stream);
}

// K11: adds vals[C, npt] onto fine[C, nfy, nfx], which the caller zeroes.
extern "C" int pt_nu2u_spread(int f64, int cplx, const void* vals, const void* coords,
                              const void* perm, const void* subs, long long nsub, void* fine,
                              int C, int cc, int nfy, int nfx, long long npt, double pery,
                              double perx, int w, double beta, int ty, int tx, void* stream) {
  return dispatch(true, f64, cplx, vals, coords, perm, subs, nsub, fine, C, cc, nfy, nfx, npt, pery,
                  perx, w, beta, ty, tx, stream);
}

// K12: keys[npt] (int16 with key_bytes 2, else int32) of the points at
// coords[npt, 2]: the tile of ty x tx fine cells that holds each one's
// first tap, its fraction in float (f64 0) or double, less offset.
extern "C" int pt_tile_keys(int f64, int key_bytes, const void* coords, void* keys, long long npt,
                            int nfy, int nfx, double pery, double perx, int w, int ty, int tx,
                            int offset, void* stream) {
  if (npt <= 0) return 0;
  if (w < 2 || w > WMAX || w > nfy || w > nfx || ty < 1 || tx < 1 || (key_bytes != 2 && key_bytes != 4)
      || (npt + KEY_BLOCK - 1) / KEY_BLOCK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) return launch_keys<double>(key_bytes, coords, keys, npt, nfy, nfx, pery, perx, w, ty, tx, offset, st);
  return launch_keys<float>(key_bytes, coords, keys, npt, nfy, nfx, pery, perx, w, ty, tx, offset, st);
}

// The largest kernel width the entry points take.
extern "C" int pt_nufft_wmax() { return WMAX; }

// The most components K10 takes at a time, for the wrapper's plan.
extern "C" int pt_nufft_point_cmax() { return POINT_CMAX; }

// The dynamic shared memory of a launch (smem_bytes), for the wrapper's plan.
extern "C" long long pt_nufft_smem_bytes(int spread, int f64, int cplx, int cc, int w, int ty,
                                         int tx) {
  return smem_bytes(spread, f64 ? 8 : 4, cplx ? 2 : 1, cc, w, ty, tx);
}
