// K13 and K14: angular distance transforms for one Hopper card (sm_90a).
// New kernels of the port: the reference computes both stages in XLA, with
// no pallas_call, in a form that does not scale to a survey map.
//
// K13 jump_flood_kernel<I> is one pass of the jump flood of
// pixell_tpu/distances.py _jump_flood (:34-54): one (step, offset) of its
// 8 offsets x len(_steps_for(n)) passes. The reference carries a state of
// (seed dec, seed ra, seed label, distance) maps and rolls it with fills
// (_shift2d :22-32) for each offset, evaluating the Vincenty angle of the
// shifted candidate at every pixel. Here the state is a seed index I (int32,
// or int64 for a seed table of 2^31 entries or more) and a float64
// distance a pixel. A seed's (dec, ra) is read from a seed table, or, where
// the seeds are pixels (the distance transforms), from the positions of
// that pixel. A launch reads the state of the last one and writes the other
// buffer of a pair (the wrapper ping-pongs), because the reference's next
// offset reads the state its last offset updated: a pass per launch keeps
// its order. A pixel (y, x) takes the seed of (y - sy, x - sx) where that
// seed is nearer, by strict < (a tie keeps its own seed, as better =
// nd < state[3] does). Rows never wrap: a candidate row outside the map is
// no candidate (a shift of ny or more fills every row). Columns wrap modulo
// nx where wrapx (jnp.roll's modulo: at the DR6-sized band, step 65536
// shifts by 22336 columns), else they fill too. A candidate equal to the
// pixel's own seed is skipped: its distance is the pixel's own, computed by
// the same function from the same inputs, so it cannot be strictly nearer.
// The init launch (init = 1) gives each seed pixel the distance to its own
// seed and the others BIG, as the reference's first dist() does.
//
// K14 nearest_point_kernel is the brute force of distance_from_points
// (:124-137, at most 1024 points) and of distance_from_points_healpix's
// "brute" (:286-296): a thread a pixel scans all points in order with
// strict <, which gives the first index of the minimum, as the reference's
// argmin within a block of points followed by bd < dmin across blocks
// does. A block stages the points through shared memory a tile at a time,
// with each point's sin and cos of dec computed once there.
//
// The angle is Vincenty's formula in utils.angdist's order of operations
// (pixell_tpu/utils.py:245-258), in double, its products and sums
// rounded one at a time (no contraction into fused multiply-adds), as the
// plain twins in ops/distances_core.py compute it.
//
// What bounds them on this card: K13 moves ~44 bytes a pixel a launch
// (its distance and seed read and written, the candidate's seed, the
// pixel's position; less for a separable geometry, whose positions are a
// column and a row) and does one Vincenty angle (three sincos, a hypot, an
// atan2) where the candidate differs from the pixel's seed: memory-bound
// once most pixels agree with their neighbours. K14 does one sincos, a
// hypot and an atan2 a pixel and point in FP64: bound by FP64 operations.
//
// The extern "C" entry points launch on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError(). No
// --use_fast_math: the angle goes through sincos, hypot and atan2.

#include <cuda_runtime.h>

namespace {

constexpr double BIG = 1e30;         // the distance where no seed has reached (distances.py:19)
constexpr int FLOOD_BLOCK = 256;     // K13: threads (pixels) a block
constexpr int NEAR_BLOCK = 256;      // K14: threads (pixels) a block, and points a staged tile

// utils.angdist: (ra1, dec1) the pixel, (ra2, dec2) the seed or point,
// sincos of dec2 given.
__device__ __forceinline__ double vincenty(double ra1, double s1, double c1, double ra2, double s2,
                                           double c2) {
  double sd, cd;
  sincos(__dsub_rn(ra2, ra1), &sd, &cd);
  double y = hypot(__dmul_rn(c2, sd), __dsub_rn(__dmul_rn(c1, s2), __dmul_rn(__dmul_rn(s1, c2), cd)));
  double x = __dadd_rn(__dmul_rn(s1, s2), __dmul_rn(__dmul_rn(c1, c2), cd));
  return atan2(y, x);
}

__device__ __forceinline__ double vincenty(double ra1, double dec1, double ra2, double dec2) {
  double s1, c1, s2, c2;
  sincos(dec1, &s1, &c1);
  sincos(dec2, &s2, &c2);
  return vincenty(ra1, s1, c1, ra2, s2, c2);
}

// The positions: dec[y * dsy + x * dsx], ra[y * rsy + x * rsx] (a stride 0
// broadcasts a separable geometry's column or row).
struct Pos {
  const double* dec;
  const double* ra;
  long long dsy, dsx, rsy, rsx;
  __device__ __forceinline__ double d(long long y, long long x) const { return dec[y * dsy + x * dsx]; }
  __device__ __forceinline__ double r(long long y, long long x) const { return ra[y * rsy + x * rsx]; }
};

template <typename I>
__global__ void __launch_bounds__(FLOOD_BLOCK)
jump_flood_kernel(const I* __restrict__ seed_in, const double* __restrict__ d_in, I* __restrict__ seed_out,
                  double* __restrict__ d_out, Pos pos, const double* __restrict__ tab_dec,
                  const double* __restrict__ tab_ra, long long ny, long long nx, long long sy,
                  long long sx, int wrapx, int init) {
  long long p = (long long)blockIdx.x * FLOOD_BLOCK + threadIdx.x;
  if (p >= ny * nx) return;
  long long y = p / nx, x = p - y * nx;
  I own = seed_in[p];
  I cand = -1;
  double d = BIG;
  if (init) {
    cand = own;
  } else {
    d = d_in[p];
    long long qy = y - sy, qx = x - sx;
    bool ok = qy >= 0 && qy < ny;
    if (wrapx) {
      qx %= nx;
      if (qx < 0) qx += nx;
    } else {
      ok = ok && qx >= 0 && qx < nx;
    }
    if (ok) cand = seed_in[qy * nx + qx];
    if (cand == own) cand = -1;
  }
  I best = own;
  if (cand >= 0) {
    double cdec, cra;
    if (tab_dec) {
      cdec = tab_dec[cand];
      cra = tab_ra[cand];
    } else {
      long long cy = (long long)cand / nx, cx = (long long)cand - cy * nx;
      cdec = pos.d(cy, cx);
      cra = pos.r(cy, cx);
    }
    double nd = vincenty(pos.r(y, x), pos.d(y, x), cra, cdec);
    if (nd < d) {
      best = cand;
      d = nd;
    }
  }
  seed_out[p] = best;
  d_out[p] = d;
}

__global__ void __launch_bounds__(NEAR_BLOCK)
nearest_point_kernel(Pos pos, long long ny, long long nx, const double* __restrict__ pt_dec,
                     const double* __restrict__ pt_ra, long long npt, double* __restrict__ dist,
                     int* __restrict__ dom) {
  __shared__ double s_sin[NEAR_BLOCK], s_cos[NEAR_BLOCK], s_ra[NEAR_BLOCK];
  long long p = (long long)blockIdx.x * NEAR_BLOCK + threadIdx.x;
  bool live = p < ny * nx;
  double pra = 0, s1 = 0, c1 = 1;
  if (live) {
    long long y = p / nx, x = p - y * nx;
    pra = pos.r(y, x);
    sincos(pos.d(y, x), &s1, &c1);
  }
  double best = BIG;
  long long bi = 0;
  for (long long t0 = 0; t0 < npt; t0 += NEAR_BLOCK) {
    int m = (int)(npt - t0 < NEAR_BLOCK ? npt - t0 : NEAR_BLOCK);
    __syncthreads();
    if (threadIdx.x < m) {
      sincos(pt_dec[t0 + threadIdx.x], &s_sin[threadIdx.x], &s_cos[threadIdx.x]);
      s_ra[threadIdx.x] = pt_ra[t0 + threadIdx.x];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; j++) {
        double nd = vincenty(pra, s1, c1, s_ra[j], s_sin[j], s_cos[j]);
        if (nd < best) {
          best = nd;
          bi = t0 + j;
        }
      }
    }
  }
  if (live) {
    dist[p] = best;
    if (dom) dom[p] = (int)bi;
  }
}

inline long long blocks(long long n, int b) { return (n + b - 1) / b; }

}  // namespace

// K13: one pass. seed_in / d_in [ny, nx] -> seed_out / d_out (other
// buffers), the seeds int32 (idx64 0) or int64; tab_dec / tab_ra the seed
// table, or null where the seeds are pixel indices; (sy, sx) the shift.
extern "C" int pt_jump_flood(int idx64, const void* seed_in, const void* d_in, void* seed_out, void* d_out,
                             const void* pos_dec, const void* pos_ra, long long dsy, long long dsx,
                             long long rsy, long long rsx, const void* tab_dec, const void* tab_ra,
                             long long ny, long long nx, long long sy, long long sx, int wrapx, int init,
                             void* stream) {
  long long n = ny * nx;
  if (n <= 0) return 0;
  if (ny < 1 || nx < 1 || blocks(n, FLOOD_BLOCK) > 0x7fffffffLL || (!tab_dec) != (!tab_ra))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pos pos{static_cast<const double*>(pos_dec), static_cast<const double*>(pos_ra), dsy, dsx, rsy, rsx};
  unsigned grid = (unsigned)blocks(n, FLOOD_BLOCK);
  const double* td = static_cast<const double*>(tab_dec);
  const double* tr = static_cast<const double*>(tab_ra);
  if (idx64)
    jump_flood_kernel<long long><<<grid, FLOOD_BLOCK, 0, st>>>(
        static_cast<const long long*>(seed_in), static_cast<const double*>(d_in),
        static_cast<long long*>(seed_out), static_cast<double*>(d_out), pos, td, tr, ny, nx, sy, sx, wrapx,
        init);
  else
    jump_flood_kernel<int><<<grid, FLOOD_BLOCK, 0, st>>>(
        static_cast<const int*>(seed_in), static_cast<const double*>(d_in), static_cast<int*>(seed_out),
        static_cast<double*>(d_out), pos, td, tr, ny, nx, sy, sx, wrapx, init);
  return (int)cudaGetLastError();
}

// K14: dist [ny, nx] float64 and, where dom is not null, dom [ny, nx]
// int32: the nearest of the npt points (pt_dec, pt_ra) and its index.
extern "C" int pt_nearest_point(const void* pos_dec, const void* pos_ra, long long dsy, long long dsx,
                                long long rsy, long long rsx, long long ny, long long nx, const void* pt_dec,
                                const void* pt_ra, long long npt, void* dist, void* dom, void* stream) {
  long long n = ny * nx;
  if (n <= 0) return 0;
  if (ny < 1 || nx < 1 || npt < 0 || npt > 0x7fffffffLL || blocks(n, NEAR_BLOCK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pos pos{static_cast<const double*>(pos_dec), static_cast<const double*>(pos_ra), dsy, dsx, rsy, rsx};
  nearest_point_kernel<<<(unsigned)blocks(n, NEAR_BLOCK), NEAR_BLOCK, 0, st>>>(
      pos, ny, nx, static_cast<const double*>(pt_dec), static_cast<const double*>(pt_ra), npt,
      static_cast<double*>(dist), static_cast<int*>(dom));
  return (int)cudaGetLastError();
}
