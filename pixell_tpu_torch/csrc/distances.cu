// K13 and K14: angular distance transforms for one Hopper card (sm_90a).
// New kernels of the port: the reference computes both stages in XLA, with
// no pallas_call, in a form that does not scale to a survey map.
//
// K13 jump_flood_kernel<I, SEP> is one pass of the jump flood of
// pixell_tpu/distances.py _jump_flood (:34-54): one (step, offset) of its
// 8 offsets x len(_steps_for(n)) passes. The reference carries a state of
// (seed dec, seed ra, seed label, distance) maps and rolls it with fills
// (_shift2d :22-32) for each offset, evaluating the Vincenty angle of the
// shifted candidate at every pixel. Here the state is the seed index I
// alone (int32, or int64 for a seed table of 2^31 entries or more; -1 where
// none): the reference's distance is always the angle to the pixel's seed
// (or BIG without one), so a pass recomputes what it needs and a last
// launch (finish, d_out given) writes d = vincenty(pixel, seed) once. A
// seed's position is a row of a seed table, or, where the seeds are pixels
// (the distance transforms), that pixel's. A launch reads the seeds the
// last one wrote and writes the other buffer of a pair (the wrapper
// ping-pongs), because the reference's next offset reads the state its
// last offset updated: a pass per launch keeps its order. A pixel (y, x)
// takes the seed of (y - sy, x - sx) where that seed is nearer, by strict
// < of the Vincenty angles (a tie keeps its own seed, as better =
// nd < state[3] does); a pixel without a seed takes any. Rows never wrap:
// a candidate row outside the map is no candidate (a shift of ny or more
// fills every row). Columns wrap modulo nx where wrapx (jnp.roll's modulo:
// at the DR6-sized band, step 65536 shifts by 22336 columns), else they
// fill too. A candidate equal to the pixel's own seed is skipped.
//
// K14 nearest_point_kernel<SEP> is the brute force of
// distance_from_points (:124-137, at most 1024 points) and of
// distance_from_points_healpix's "brute" (:286-296): a thread takes NEAR_R
// pixels and scans all points in order, keeping the first index of the
// least Vincenty angle (strict <), as the reference's argmin within a
// block of points followed by bd < dmin across blocks does. A block stages
// the points' unit vectors in shared memory a tile at a time; a warp reads
// one point at a time (a broadcast).
//
// Both kernels decide "nearer" by unit vectors, float64
// (cos dec cos ra, cos dec sin ra, sin dec), from (sin, cos) tables the
// wrapper makes once a call: the larger dot product with the pixel's
// vector is the smaller angle. Where two dot products lie within the
// margin M of each other (ops/distances_cuda.py MARGIN, derived there from
// the rounding of the vectors, the dot product and the angle), the two
// Vincenty angles decide, in utils.angdist's order of operations
// (pixell_tpu/utils.py:245-258), in double, its products and sums rounded
// one at a time (no contraction into fused multiply-adds), as the plain
// twins in ops/distances_core.py compute it. Outside the margin the dot
// products give the Vincenty decision, so the results are the twins' bit
// for bit. The dot product is two FMAs and a multiply, each rounded as
// written (__fma_rn, __dmul_rn): M bounds exactly that arithmetic. SEP
// instantiations read a separable geometry's tables by row and column.
//
// What bounds them on this card: K13 moves 12 bytes a pixel a launch (its
// seed and the candidate's read, a seed written; the finish reads a seed
// and writes a float64 distance) and does two dot products where the
// candidate differs from the pixel's seed: memory-bound, and waiting on
// the reads of seeds and then of their table rows, so a thread reads
// FLOOD_PX pixels' seeds at once. K14 does a dot product a pixel and
// point (its filter: 2 + 2 / NEAR_R FMAs on a separable geometry, else 3, and
// an integer AND of a sign bit) and one angle a pixel: bound by FP64
// operations.
//
// The extern "C" entry points launch on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError(). No
// --use_fast_math: the angle goes through sincos, hypot and atan2.

#include <cuda_runtime.h>

namespace {

constexpr double BIG = 1e30;         // the distance where no seed has reached (distances.py:19)
constexpr int FLOOD_BLOCK = 256;     // K13: threads a block
constexpr int FLOOD_PX = 4;          // K13: pixels of a row a thread
constexpr int FLOOD_MIN_BLOCKS = 4;  // K13: blocks an SM, which caps a thread's registers at 64
constexpr int NEAR_BLOCK = 256;      // K14: threads a block
constexpr int NEAR_R = 4;            // K14: pixels a thread (on the DR6-sized band faster than 1 or 2)
constexpr int NEAR_TILE = 1024;      // K14: points a staged tile (24 KB of shared memory)
constexpr int NEAR_STEP = 4;         // K14: points a step of the filter
static_assert(NEAR_TILE % NEAR_STEP == 0, "a staged tile holds whole steps");
constexpr long long MAX_ROW_BLOCKS = 65535;   // K13: the grid's rows (a block walks its rows by this stride)

// utils.angdist: (ra1, dec1) the pixel, (ra2, dec2) the seed or point,
// sin and cos of both decs given.
__device__ __forceinline__ double vincenty(double ra1, double s1, double c1, double ra2, double s2,
                                           double c2) {
  double sd, cd;
  sincos(__dsub_rn(ra2, ra1), &sd, &cd);
  double y = hypot(__dmul_rn(c2, sd), __dsub_rn(__dmul_rn(c1, s2), __dmul_rn(__dmul_rn(s1, c2), cd)));
  double x = __dadd_rn(__dmul_rn(s1, s2), __dmul_rn(__dmul_rn(c1, c2), cd));
  return atan2(y, x);
}

__device__ __forceinline__ double dot(double ax, double ay, double az, double bx, double by, double bz) {
  return __fma_rn(az, bz, __fma_rn(ay, by, __dmul_rn(ax, bx)));
}

// A position's unit vector, for the dot products, and (ra, sin dec, cos
// dec), for the angle.
struct Unit {
  double x, y, z;
};
struct Sph {
  double ra, s, c;
};

__device__ __forceinline__ double dot(const Unit& a, const Unit& b) { return dot(a.x, a.y, a.z, b.x, b.y, b.z); }

__device__ __forceinline__ double vincenty(const Sph& a, const Sph& b) {
  return vincenty(a.ra, a.s, a.c, b.ra, b.s, b.c);
}

// The same, compiled once and called from K14's rare paths: inlined at
// each of them, the angle's code would push its scan's instructions apart.
// (K13 inlines it: a call there makes ptxas spill the registers live
// across it.)
__device__ __noinline__ double vincenty_call(Sph a, Sph b) { return vincenty(a, b); }

// The pixels' tables: (sin dec, cos dec) pairs at [y * dsy + x * dsx], ra
// and (cos ra, sin ra) pairs at [y * rsy + x * rsx] (a stride 0
// broadcasts a separable geometry's column or row: SEP, dsy = rsx = 1 and
// dsx = rsy = 0, reads them at y and x). A flat index k splits by nx in
// 32-bit arithmetic where narrow (the map has fewer than 2^31 pixels):
// k / nx = (k * mag) >> sh with mag = ceil(2^sh / nx), sh = 31 +
// ceil(log2 nx), exact for k < 2^31.
struct Pix {
  const double2 *dsc, *rcs;
  const double* ra;
  long long dsy, dsx, rsy, rsx, nx;
  unsigned mag;
  int sh, narrow;
  __device__ __forceinline__ void split(long long k, long long& y, long long& x) const {
    if (narrow) {
      unsigned q = (unsigned)(((unsigned long long)(unsigned)k * mag) >> sh);
      y = q;
      x = (unsigned)k - q * (unsigned)nx;
    } else {
      y = k / nx;
      x = k - y * nx;
    }
  }
  template <bool SEP>
  __device__ __forceinline__ long long di(long long y, long long x) const { return SEP ? y : y * dsy + x * dsx; }
  template <bool SEP>
  __device__ __forceinline__ long long ri(long long y, long long x) const { return SEP ? x : y * rsy + x * rsx; }
  // the unit vector from a (sin dec, cos dec) and a (cos ra, sin ra) pair
  __device__ __forceinline__ static Unit unit(double2 d, double2 r) {
    return Unit{__dmul_rn(d.y, r.x), __dmul_rn(d.y, r.y), d.x};
  }
  template <bool SEP>
  __device__ __forceinline__ Unit unit(long long y, long long x) const {
    return unit(__ldg(dsc + di<SEP>(y, x)), __ldg(rcs + ri<SEP>(y, x)));
  }
  template <bool SEP>
  __device__ __forceinline__ Sph sph(long long y, long long x) const {
    double2 d = __ldg(dsc + di<SEP>(y, x));
    return Sph{__ldg(ra + ri<SEP>(y, x)), d.x, d.y};
  }
};

// A seed or point k of a table: vec [n, 4] unit vectors (x, y, z, 0), sph
// [n, 3] (ra, sin dec, cos dec).
__device__ __forceinline__ Unit table_unit(const double* __restrict__ vec, long long k) {
  const double2* v = reinterpret_cast<const double2*>(vec + 4 * k);
  const double2 a = __ldg(v), b = __ldg(v + 1);
  return Unit{a.x, a.y, b.x};
}
__device__ __forceinline__ Sph table_sph(const double* __restrict__ sph, long long k) {
  return Sph{__ldg(sph + 3 * k), __ldg(sph + 3 * k + 1), __ldg(sph + 3 * k + 2)};
}

// A seed's unit vector and angle inputs: a row of the table where one is
// given (vec), else the pixel of index k.
template <bool SEP, typename I>
__device__ __forceinline__ Unit seed_unit(const Pix& pix, const double* __restrict__ vec, I k) {
  if (vec) return table_unit(vec, (long long)k);
  long long y, x;
  pix.split((long long)k, y, x);
  return pix.unit<SEP>(y, x);
}
template <bool SEP, typename I>
__device__ __forceinline__ Sph seed_sph(const Pix& pix, const double* __restrict__ sph, I k) {
  if (sph) return table_sph(sph, (long long)k);
  long long y, x;
  pix.split((long long)k, y, x);
  return pix.sph<SEP>(y, x);
}

// K13's decision at one pixel (y, x), its unit vector q, between its own
// seed and a candidate (both >= 0 and different): the candidate if it is
// nearer.
template <bool SEP, typename I>
__device__ __forceinline__ bool nearer(const Pix& pix, const double* __restrict__ vec,
                                       const double* __restrict__ sph, long long y, long long x, const Unit& q,
                                       I own, I cand, double margin) {
  const double dc = dot(q, seed_unit<SEP>(pix, vec, cand)), dn = dot(q, seed_unit<SEP>(pix, vec, own));
  if (dc > __dadd_rn(dn, margin)) return true;
  if (dc < __dsub_rn(dn, margin)) return false;
  // within the margin: the angles decide
  const Sph p = pix.sph<SEP>(y, x);
  return vincenty(p, seed_sph<SEP>(pix, sph, cand)) < vincenty(p, seed_sph<SEP>(pix, sph, own));
}

// K13: one pass (d_out null) or the finish (d_out given). A thread takes
// FLOOD_PX pixels of a row, FLOOD_BLOCK apart, and reads all their seeds
// and candidates before it decides any (the loads overlap: a pass waits on
// memory, not on arithmetic); blockIdx.y is the row (and those
// MAX_ROW_BLOCKS further on). FLOOD_MIN_BLOCKS blocks an SM (at most 64
// registers a thread): more warps in flight hide more of that wait (one
// more block, or eight pixels a thread, and ptxas spills).
template <typename I, bool SEP>
__global__ void __launch_bounds__(FLOOD_BLOCK, FLOOD_MIN_BLOCKS)
jump_flood_kernel(const I* __restrict__ seed_in, I* __restrict__ seed_out, double* __restrict__ d_out, Pix pix,
                  const double* __restrict__ vec, const double* __restrict__ sph, long long ny,
                  long long sy, long long sx, int wrapx, double margin) {
  const long long nx = pix.nx;
  const long long x0 = (long long)blockIdx.x * (FLOOD_BLOCK * FLOOD_PX) + threadIdx.x;
  if (x0 >= nx) return;
  for (long long y = blockIdx.y; y < ny; y += gridDim.y) {
    const I* row = seed_in + y * nx;
    if (d_out) {
#pragma unroll
      for (int k = 0; k < FLOOD_PX; k++) {
        const long long x = x0 + k * FLOOD_BLOCK;
        if (x >= nx) break;
        const I own = row[x];
        double d = BIG;
        if (own >= 0) d = vincenty(pix.sph<SEP>(y, x), seed_sph<SEP>(pix, sph, own));
        d_out[y * nx + x] = d;
      }
      continue;
    }
    // sx is reduced to [0, nx) by the entry point where wrapx
    const long long qy = y - sy;
    const bool yok = qy >= 0 && qy < ny;
    const I* qrow = seed_in + (yok ? qy : 0) * nx;
    I own[FLOOD_PX], cand[FLOOD_PX];
    const double2 dq = SEP ? __ldg(pix.dsc + y) : make_double2(0, 0);   // the row's (sin dec, cos dec)
#pragma unroll
    for (int k = 0; k < FLOOD_PX; k++) {
      const long long x = x0 + k * FLOOD_BLOCK;
      long long qx = x - sx;
      if (wrapx && qx < 0) qx += nx;
      const bool live = x < nx;
      own[k] = live ? row[x] : (I)-1;
      cand[k] = live && yok && qx >= 0 && qx < nx ? qrow[qx] : (I)-1;
    }
#pragma unroll
    for (int k = 0; k < FLOOD_PX; k++) {
      const long long x = x0 + k * FLOOD_BLOCK;
      if (x >= nx) break;
      I best = own[k];
      if (cand[k] >= 0 && cand[k] != own[k]) {
        if (own[k] < 0) {
          best = cand[k];
        } else {
          const Unit q = SEP ? Pix::unit(dq, __ldg(pix.rcs + x)) : pix.unit<false>(y, x);
          if (nearer<SEP>(pix, vec, sph, y, x, q, own[k], cand[k], margin)) best = cand[k];
        }
      }
      seed_out[y * nx + x] = best;
    }
  }
}

// K14: R = NEAR_R pixels a thread, all npt points: on a separable geometry
// (SEP) rows r0 .. r0 + R - 1 of one column, which share the column's cos and sin
// of ra, else pixels p0, p0 + NEAR_BLOCK, ... of the flat map. The scan
// filters NEAR_STEP points at a time by dot - thr (thr = the best dot
// product less the margin), from FMAs in one chain, and integer ANDs of
// its sign bits (no FP64 compare: DSETP costs the FP64 pipe more than an
// FMA). On SEP, a point's a = cos ra cx + sin ra cy is shared by the R
// rows, and dot - thr = cos dec a + (sin dec cz - thr): 2 + 2 / R FMAs a
// pixel and point, else 3. A step in which some point may reach a
// pixel's threshold (rare: the best point changes a few times a pixel) is
// gone through again point by point with the dot product proper d: a
// filter value with its sign bit set means d < thr + 9u
// (ops/distances_cuda.py MARGIN derives it), so no point the margin's
// comparison could take is dropped.
template <bool SEP>
__global__ void __launch_bounds__(NEAR_BLOCK)
nearest_point_kernel(Pix pix, long long ny, const double* __restrict__ vec, const double* __restrict__ sph,
                     int npt, double margin, double* __restrict__ dist, int* __restrict__ dom) {
  constexpr int R = NEAR_R;
  __shared__ double2 s_xy[NEAR_TILE];
  __shared__ double s_z[NEAR_TILE];
  const long long nx = pix.nx;
  // the thread's pixels (py, px), live where on the map; per pixel the
  // best point's dot product bd and index bi, nthr = -thr (a pixel past
  // the map never looks), the best point's angle vb once computed (-1
  // before); its unit vector (ux, uy, uz), on SEP from cos and sin of its
  // dec (cd, sd) and of its column's ra (ca, sa)
  long long py[R], px[R];
  bool live[R];
  double ux[R], uy[R], uz[R], bd[R], nthr[R], vb[R], ca = 0, sa = 0;
  int bi[R];
  if (SEP) {
    const long long ncb = (nx + NEAR_BLOCK - 1) / NEAR_BLOCK, g = blockIdx.x / ncb;
    const long long x = (blockIdx.x - g * ncb) * NEAR_BLOCK + threadIdx.x;
    if (x < nx) {
      const double2 r = __ldg(pix.rcs + x);
      ca = r.x;
      sa = r.y;
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      py[r] = g * R + r;
      px[r] = x;
      live[r] = py[r] < ny && x < nx;
    }
  } else {
    const long long n = ny * nx, p0 = (long long)blockIdx.x * (NEAR_BLOCK * R) + threadIdx.x;
#pragma unroll
    for (int r = 0; r < R; r++) {
      const long long p = p0 + (long long)r * NEAR_BLOCK;
      live[r] = p < n;
      py[r] = px[r] = 0;
      if (live[r]) pix.split(p, py[r], px[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; r++) {
    ux[r] = uy[r] = uz[r] = 0;
    if (live[r]) {
      // on SEP, ux / uy hold cos dec and the unit vector's x / y are formed where needed
      if (SEP) {
        const double2 d = __ldg(pix.dsc + py[r]);
        ux[r] = d.y;
        uz[r] = d.x;
      } else {
        const Unit q = pix.unit<false>(py[r], px[r]);
        ux[r] = q.x;
        uy[r] = q.y;
        uz[r] = q.z;
      }
    }
    bd[r] = -4;                      // below every dot product: the first point is taken
    nthr[r] = live[r] ? 5 : -4;
    vb[r] = -1;
    bi[r] = -1;
  }
  for (int t0 = 0; t0 < npt; t0 += NEAR_TILE) {
    const int m = npt - t0 < NEAR_TILE ? npt - t0 : NEAR_TILE;
    __syncthreads();
    // past m, to a multiple of NEAR_STEP, zero vectors: the filter may let
    // them through, the points' own pass below never takes them
    for (int k = threadIdx.x; k < (m + NEAR_STEP - 1) / NEAR_STEP * NEAR_STEP; k += NEAR_BLOCK) {
      double x = 0, y = 0, z = 0;
      if (k < m) {
        const Unit v = table_unit(vec, t0 + k);
        x = v.x;
        y = v.y;
        z = v.z;
      }
      s_xy[k] = make_double2(x, y);
      s_z[k] = z;
    }
    __syncthreads();
    for (int j0 = 0; j0 < m; j0 += NEAR_STEP) {
      // the filter, a pixel at a time, so that consecutive FMAs share two
      // operands, which the register file's reuse cache then serves
      double2 cxy[NEAR_STEP];
      double cz[NEAR_STEP], e[R][NEAR_STEP];
      int all_below = -1;
#pragma unroll
      for (int u = 0; u < NEAR_STEP; u++) {
        cxy[u] = s_xy[j0 + u];
        cz[u] = s_z[j0 + u];
      }
      if (SEP) {
        double a[NEAR_STEP];
#pragma unroll
        for (int u = 0; u < NEAR_STEP; u++) a[u] = __fma_rn(sa, cxy[u].y, __dmul_rn(ca, cxy[u].x));
#pragma unroll
        for (int r = 0; r < R; r++)
#pragma unroll
          for (int u = 0; u < NEAR_STEP; u++) e[r][u] = __fma_rn(uz[r], cz[u], nthr[r]);
#pragma unroll
        for (int r = 0; r < R; r++)
#pragma unroll
          for (int u = 0; u < NEAR_STEP; u++) all_below &= __double2hiint(__fma_rn(ux[r], a[u], e[r][u]));
      } else {
#pragma unroll
        for (int r = 0; r < R; r++)
#pragma unroll
          for (int u = 0; u < NEAR_STEP; u++) e[r][u] = __fma_rn(ux[r], cxy[u].x, nthr[r]);
#pragma unroll
        for (int r = 0; r < R; r++)
#pragma unroll
          for (int u = 0; u < NEAR_STEP; u++) e[r][u] = __fma_rn(uy[r], cxy[u].y, e[r][u]);
#pragma unroll
        for (int r = 0; r < R; r++)
#pragma unroll
          for (int u = 0; u < NEAR_STEP; u++) all_below &= __double2hiint(__fma_rn(uz[r], cz[u], e[r][u]));
      }
      if (all_below < 0) continue;
      // some point of the step may: each point in order, by its dot product
#pragma unroll
      for (int u = 0; u < NEAR_STEP; u++) {
        if (j0 + u >= m) break;
        const Unit c{cxy[u].x, cxy[u].y, cz[u]};
        const int k = t0 + j0 + u;
#pragma unroll
        for (int r = 0; r < R; r++) {
          const Unit q = SEP ? Unit{__dmul_rn(ux[r], ca), __dmul_rn(ux[r], sa), uz[r]} : Unit{ux[r], uy[r], uz[r]};
          const double d = dot(q, c);
          if (d < -nthr[r]) continue;
          if (d > __dadd_rn(bd[r], margin)) {
            bd[r] = d;
            nthr[r] = -__dsub_rn(d, margin);
            bi[r] = k;
            vb[r] = -1;
          } else {   // within the margin: the angles decide
            const Sph p = pix.sph<SEP>(py[r], px[r]);
            if (vb[r] < 0) vb[r] = vincenty_call(p, table_sph(sph, bi[r]));
            const double v = vincenty_call(p, table_sph(sph, k));
            if (v < vb[r]) {
              bd[r] = d;
              nthr[r] = -__dsub_rn(d, margin);
              bi[r] = k;
              vb[r] = v;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; r++) {
    if (!live[r]) continue;
    double d = BIG;
    if (bi[r] >= 0) d = vb[r] >= 0 ? vb[r] : vincenty_call(pix.sph<SEP>(py[r], px[r]), table_sph(sph, bi[r]));
    dist[py[r] * nx + px[r]] = d;
    if (dom) dom[py[r] * nx + px[r]] = bi[r] < 0 ? 0 : bi[r];
  }
}

inline long long blocks(long long n, long long b) { return (n + b - 1) / b; }

Pix make_pix(const void* dec_sc, long long dsy, long long dsx, const void* ra, const void* ra_cs, long long rsy,
             long long rsx, long long ny, long long nx) {
  const bool narrow = ny * nx < 0x80000000LL;
  int l = 0;
  while ((1LL << l) < nx) l++;
  const unsigned long long d = (unsigned long long)nx, mag = narrow ? ((1ULL << (31 + l)) + d - 1) / d : 0;
  return Pix{static_cast<const double2*>(dec_sc), static_cast<const double2*>(ra_cs), static_cast<const double*>(ra),
             dsy, dsx, rsy, rsx, nx, (unsigned)mag, 31 + l, narrow};
}

// The tables of a separable geometry: dec by row, ra by column.
bool separable(const Pix& pix) { return pix.dsy == 1 && pix.dsx == 0 && pix.rsy == 0 && pix.rsx == 1; }

template <typename I>
void launch_flood(const void* seed_in, void* seed_out, double* d, const Pix& pix, const double* tv,
                  const double* ts, long long ny, long long sy, long long sx, int wrapx, double margin,
                  cudaStream_t st) {
  dim3 grid((unsigned)blocks(pix.nx, FLOOD_BLOCK * FLOOD_PX), (unsigned)(ny < MAX_ROW_BLOCKS ? ny : MAX_ROW_BLOCKS));
  const I* in = static_cast<const I*>(seed_in);
  I* out = static_cast<I*>(seed_out);
  if (separable(pix))
    jump_flood_kernel<I, true><<<grid, FLOOD_BLOCK, 0, st>>>(in, out, d, pix, tv, ts, ny, sy, sx, wrapx, margin);
  else
    jump_flood_kernel<I, false><<<grid, FLOOD_BLOCK, 0, st>>>(in, out, d, pix, tv, ts, ny, sy, sx, wrapx, margin);
}

}  // namespace

// K13: one pass, seed_in [ny, nx] -> seed_out (another buffer), or, where
// d_out is given, the finish: d_out [ny, nx] float64, the angle from each
// pixel to its seed (BIG where none). Seeds int32 (idx64 0) or int64; the
// pixels' tables dec_sc (sin dec, cos dec pairs; element strides dsy, dsx
// in pairs), ra and ra_cs (cos ra, sin ra pairs; strides rsy, rsx in
// elements and pairs alike); vec [nseed, 4] / sph [nseed, 3] the seed
// table, or null where the seeds are pixel indices; (sy, sx) the shift;
// margin MARGIN.
extern "C" int pt_jump_flood(int idx64, const void* seed_in, void* seed_out, void* d_out, const void* dec_sc,
                             long long dsy, long long dsx, const void* ra, const void* ra_cs, long long rsy,
                             long long rsx, const void* vec, const void* sph, long long ny, long long nx,
                             long long sy, long long sx, int wrapx, double margin, void* stream) {
  if (ny < 1 || nx < 1) return ny * nx == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (blocks(nx, FLOOD_BLOCK) > 0x7fffffffLL || (!vec) != (!sph) || (!d_out && !seed_out) || !(margin >= 0))
    return (int)cudaErrorInvalidValue;
  if (wrapx) sx = ((sx % nx) + nx) % nx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pix pix = make_pix(dec_sc, dsy, dsx, ra, ra_cs, rsy, rsx, ny, nx);
  const double* tv = static_cast<const double*>(vec);
  const double* ts = static_cast<const double*>(sph);
  double* d = static_cast<double*>(d_out);
  if (idx64)
    launch_flood<long long>(seed_in, seed_out, d, pix, tv, ts, ny, sy, sx, wrapx, margin, st);
  else
    launch_flood<int>(seed_in, seed_out, d, pix, tv, ts, ny, sy, sx, wrapx, margin, st);
  return (int)cudaGetLastError();
}

// K14: dist [ny, nx] float64 and, where dom is not null, dom [ny, nx]
// int32: the nearest of the npt points (vec [npt, 4], sph [npt, 3]) and
// its index (BIG and 0 without points); the pixels' tables as K13's.
extern "C" int pt_nearest_point(const void* dec_sc, long long dsy, long long dsx, const void* ra,
                                const void* ra_cs, long long rsy, long long rsx, long long ny, long long nx,
                                const void* vec, const void* sph, long long npt, double margin, void* dist,
                                void* dom, void* stream) {
  long long n = ny * nx;
  if (ny < 1 || nx < 1) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (npt < 0 || npt > 0x7fffffffLL || !(margin >= 0) || blocks(n, NEAR_BLOCK * NEAR_R) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pix pix = make_pix(dec_sc, dsy, dsx, ra, ra_cs, rsy, rsx, ny, nx);
  const double* tv = static_cast<const double*>(vec);
  const double* ts = static_cast<const double*>(sph);
  double* d = static_cast<double*>(dist);
  int* m = static_cast<int*>(dom);
  if (separable(pix)) {
    const long long g = blocks(nx, NEAR_BLOCK) * blocks(ny, NEAR_R);
    if (g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    nearest_point_kernel<true><<<(unsigned)g, NEAR_BLOCK, 0, st>>>(pix, ny, tv, ts, (int)npt, margin, d, m);
  } else {
    const unsigned g = (unsigned)blocks(n, NEAR_BLOCK * NEAR_R);
    nearest_point_kernel<false><<<g, NEAR_BLOCK, 0, st>>>(pix, ny, tv, ts, (int)npt, margin, d, m);
  }
  return (int)cudaGetLastError();
}
