// Hand-written Hopper (sm_90a) kernels for the block-Legendre split of the
// spherical harmonic transform's Legendre stage
// (pixell_tpu/ops/sht_pallas.py:556-610). Two kernels, four TPU kernels:
//
//   blk_synthesis  K8a, replaces _synth_blk_call
//                       (pixell_tpu/ops/sht_pallas.py:888, pallas_call :997)
//                  K8b, replaces _synth_blk_call_streams (:1032, :1145)
//   blk_analysis   K8c, replaces _anal_blk_call (:1220, :1319)
//                  K8d, replaces _anal_blk_call_streams (:1350, :1457)
//
// K8a/K8c are the scalar mode, K8b/K8d the deriv, spin1 and spin2 modes. The
// mode is a compile-time constant; this file is compiled once per mode
// (-DLEGENDRE_MODE=0..3), and each object exports pt_blk_<kernel>_<mode>.
//
// Maths (the plain PyTorch twin is pixell_tpu_torch/ops/sht_core.py
// blk_synthesis / blk_analysis). Within a block of LBK = 112 degrees that
// holds no seed, the scaled recurrence
//   lambda_l = a_lm ((cos theta) lambda_{l-1} - b_lm lambda_{l-2})
// is linear in the state (curr, prev) at the block's entry:
//   lambda_{l0+k} = gA_k(cos theta) curr + gB_k(cos theta) prev,
// where gA_k, gB_k are polynomials of degree <= k + 1 in cos theta that obey
// the same recurrence from (gA, gB) = (1, 0) and (0, 1). On a tile of rings
// they are carried as VALUES at the JP = 128 Chebyshev nodes of the tile's
// cos theta interval; their sums against the alm (synthesis) or against the
// ring data (analysis) fold at the nodes, and one node -> ring product with
// W[j, t] = l_j(cos theta_t), the Lagrange basis through the nodes, takes
// them to the rings: 112 recurrence steps at 128 nodes and one product, in
// place of 112 steps at every ring. The stepwise kernels K3/K4 (legendre.cu)
// run each tile up to its handoff degree, where the recurrence has become
// oscillatory on the whole tile (ops/sht_cuda.py blk_start_table), and dump
// their state; these kernels resume from it.
//
// The spin and derivative modes separate into coefficient streams:
// u_f = sum_s c_s(l, m) x (lambda_l or lambda_{l-1}) x (a ring factor)
// (_blk_mode_spec sht_pallas.py:774; ops/sht_core.py blk_stream_tables,
// blk_combine, blk_fields). Stream s of family 1 weighs the previous chain
// value. Scalar is one stream with coefficient 1.
//
// What bounds these kernels on an H100: FP32 arithmetic. Per m row and
// 112-degree block the build costs 128 x 112 x (6 + 4 NS C) operations, the
// node -> ring product 2 x (2 NS C + 4) x 128 x BT. The TPU gave the
// product to its matrix unit; here it runs on the CUDA cores with FP32 FMAs
// from shared memory, the full-precision product the reference asked of its
// unit (Precision.HIGHEST, :970-979), which is why the split need not pay on
// this card. No --use_fast_math.
// Design: one CUDA block owns one (m tile, ring tile) pair of BM = 4 m rows
// by BT = 256 rings and loops over its 112-degree blocks from its start
// block to the last, with the recurrence state of its 1024 entries in
// registers (the TPU's sequential third grid axis and its VMEM scratch).
// Each of the 512 threads plays two parts: in the build it owns one
// (m row, node), in the product and the state update two (m row, ring)
// entries, the same ring in two m rows, so one W value serves both.
// a, b, the alm times the stream coefficients and the node folds live in
// dynamic shared memory (up to ~104 KB, spin2 with C = 4); W is read from
// global memory, where all m tiles of a ring tile share it through L2.
// The analysis kernel contracts the rings first (Wc = (curr fac G) W^T per
// field), holds Wc, Wp in the node threads' registers through the build,
// and reduces over the nodes eight degrees at a time from a shared-memory
// slab, one warp butterfly per (degree, column, m row). Like K4 it writes
// partial sums per plane of ring tiles into a zeroed [planes, nl, nm, C]
// buffer that is summed afterwards: no atomics.
//
// Every extern "C" entry point launches on the given stream, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>

#ifndef LEGENDRE_MODE
#define LEGENDRE_MODE 0
#endif
#if LEGENDRE_MODE == 0
#define MODE_TAG scalar
#elif LEGENDRE_MODE == 1
#define MODE_TAG deriv
#elif LEGENDRE_MODE == 2
#define MODE_TAG spin1
#elif LEGENDRE_MODE == 3
#define MODE_TAG spin2
#else
#error "LEGENDRE_MODE must be 0 (scalar), 1 (deriv), 2 (spin1) or 3 (spin2)"
#endif
#define PT_PASTE2(a, b) a##_##b
#define PT_PASTE(a, b) PT_PASTE2(a, b)
#define PT_ENTRY(name) PT_PASTE(name, MODE_TAG)

namespace {

constexpr int SCALAR = 0, DERIV = 1, SPIN1 = 2, SPIN2 = 3;
constexpr int MODE = LEGENDRE_MODE;
constexpr int NFUN = MODE == SCALAR ? 1 : 2;
constexpr int NS = MODE == SCALAR ? 1 : (MODE == SPIN2 ? 4 : 3);  // streams

// family of stream s: true where it weighs lambda_{l-1}, the previous chain value
__host__ __device__ constexpr bool fam_prev(int s) {
  return MODE == SPIN2 ? s == 2 : (MODE == DERIV ? s == 2 : (MODE == SPIN1 ? s == 1 : false));
}

constexpr int LBK = 112;  // degrees per block
constexpr int JP = 128;   // Chebyshev nodes per ring tile
constexpr int BM = 4;     // m rows per tile
constexpr int BT = 256;   // rings per tile
constexpr int NTHREADS = BM * JP;            // one thread per (m row, node)
constexpr int EPT = BM * BT / NTHREADS;      // (m row, ring) entries per thread
constexpr int KS = 8;     // degrees per node-reduction slab (analysis)
static_assert(NTHREADS % BT == 0 && EPT * (NTHREADS / BT) == BM && LBK % KS == 0 &&
                  JP == 128 && BT % 4 == 0,
              "tile sizes");

__device__ __forceinline__ float band() { return 0x1p60f; }
__device__ __forceinline__ float invband() { return 0x1p-60f; }

// The state's emission factor by level: only levels 0, -1 and -2 can reach
// above 2^-120 (FAC_M2, sht_pallas.py:611).
__device__ __forceinline__ float level_factor(int lev) {
  return lev == 0 ? 1.0f : (lev == -1 ? 0x1p-60f : (lev == -2 ? 0x1p-120f : 0.0f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One thread's two parts.
struct Who {
  int tid, mi, j;  // the node part: m row and node
  int t;           // the ring part: ring in the tile, in m rows emi(0..EPT-1)
  __device__ __forceinline__ Who() {
    tid = threadIdx.x;
    mi = tid / JP;
    j = tid % JP;
    t = tid % BT;
  }
  __device__ __forceinline__ int emi(int e) const { return tid / BT + e * (NTHREADS / BT); }
};

// The recurrence state of one thread's ring entries.
struct Entries {
  float prev[EPT], curr[EPT];
  int lev[EPT];
};

// state [3, nm, nt]: prev, curr, level as a number; zero outside the grid.
__device__ __forceinline__ void load_entries(Entries& s, const float* __restrict__ state,
                                             const Who& w, int m0, int t0, int nm, int nt) {
  const size_t plane = (size_t)nm * nt;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int m = m0 + w.emi(e), t = t0 + w.t;
    const bool valid = m < nm && t < nt;
    const size_t mt = (size_t)m * nt + t;
    s.prev[e] = valid ? state[mt] : 0.0f;
    s.curr[e] = valid ? state[plane + mt] : 0.0f;
    s.lev[e] = valid ? (int)state[2 * plane + mt] : 0;
  }
}

// Stage a_lm, b_lm of degrees l0 .. l0+LBK-1 for the tile's m rows into
// sa, sb [LBK][BM]; zero outside the tables, which ends the chains there.
__device__ __forceinline__ void stage_ab(float* sa, float* sb, const float* __restrict__ ab,
                                         int l0, int m0, int nl, int nm, int tid) {
  const size_t nlm = (size_t)nl * nm;
  for (int i = tid; i < LBK * BM; i += NTHREADS) {
    const int l = l0 + i / BM, m = m0 + i % BM;
    const bool ok = l < nl && m < nm;
    const size_t lm = (size_t)l * nm + m;
    sa[i] = ok ? ab[lm] : 0.0f;
    sb[i] = ok ? ab[nlm + lm] : 0.0f;
  }
}

// acc[e][r] = sum_j L[row0 + r][emi(e)][j] W[j][t] for the thread's ring
// entries: the node -> ring product, FP32 FMAs. sL [rows][BM][JP] in shared
// memory, Wt the tile's W [JP][BT] in global memory.
template <int NR>
__device__ __forceinline__ void to_rings(float (&acc)[EPT][NR], const float* sL, int row0,
                                         const float* __restrict__ Wt, const Who& w) {
#pragma unroll
  for (int e = 0; e < EPT; ++e)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[e][r] = 0.0f;
  for (int j = 0; j < JP; j += 4) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = Wt[(size_t)(j + q) * BT + w.t];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 l = *reinterpret_cast<const float4*>(
            &sL[((size_t)(row0 + r) * BM + w.emi(e)) * JP + j]);
        acc[e][r] = fmaf(l.x, wv[0], acc[e][r]);
        acc[e][r] = fmaf(l.y, wv[1], acc[e][r]);
        acc[e][r] = fmaf(l.z, wv[2], acc[e][r]);
        acc[e][r] = fmaf(l.w, wv[3], acc[e][r]);
      }
  }
}

// Carry the state over a block: E holds the chains' end values at the
// entry's ring, rows (gA_c, gA_p, gB_c, gB_p); then renormalize
// (sht_pallas.py:990-992).
__device__ __forceinline__ void step_state(Entries& s, const float (&E)[EPT][4]) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    float nc = E[e][0] * s.curr[e] + E[e][2] * s.prev[e];
    float np = E[e][1] * s.curr[e] + E[e][3] * s.prev[e];
    if (fabsf(nc) > band()) {
      np *= invband();
      nc *= invband();
      s.lev[e] += 1;
    }
    s.prev[e] = np;
    s.curr[e] = nc;
  }
}

// The ring factors of one ring.
struct RingRow {
  float ct, cts, ist, ist2;
};

__device__ __forceinline__ RingRow load_row(const float* __restrict__ cth,
                                            const float* __restrict__ rows, int t, int nt) {
  RingRow r{0.0f, 0.0f, 0.0f, 0.0f};
  if (t < nt) {
    r.ct = cth[t];
    if constexpr (MODE != SCALAR) {
      r.cts = rows[t];
      r.ist = rows[nt + t];
      r.ist2 = rows[2 * nt + t];
    }
  }
  return r;
}

// u[NFUN]: the mode functions' sums from the interpolated stream sums ts[NS]
// (_blk_mode_spec synth_combine, sht_pallas.py:786-802).
template <int M>
__device__ __forceinline__ void combine(float (&u)[NFUN], const float (&ts)[NS],
                                        const RingRow& r, float mf) {
  if constexpr (M == SCALAR) {
    u[0] = ts[0];
  } else if constexpr (M == DERIV) {
    u[0] = ts[0];
    u[NFUN - 1] = r.cts * ts[1] + r.ist * ts[NS - 1];
  } else if constexpr (M == SPIN1) {
    u[0] = r.cts * ts[0] + r.ist * ts[1];
    u[NFUN - 1] = mf * (r.ist * ts[NS - 1]);
  } else {
    const float ctist2 = r.ct * r.ist2;
    u[0] = ts[0] + r.ist2 * ts[1] + ctist2 * ts[2];
    u[NFUN - 1] = mf * (ctist2 * ts[NS - 1] + r.ist2 * ts[2]);
  }
}

// g[NS]: the ring-weighted fields the streams contract against, the
// transpose of combine (_blk_mode_spec anal_fields, :790-804). F0, F1: the
// data of the mode's first and last function.
template <int M>
__device__ __forceinline__ void fields(float (&g)[NS], float F0, float F1, const RingRow& r,
                                       float mf) {
  if constexpr (M == SCALAR) {
    g[0] = F0;
  } else if constexpr (M == DERIV) {
    g[0] = F0;
    g[1] = r.cts * F1;
    g[NS - 1] = r.ist * F1;
  } else if constexpr (M == SPIN1) {
    g[0] = r.cts * F0;
    g[1] = r.ist * F0;
    g[NS - 1] = mf * (r.ist * F1);
  } else {
    g[0] = F0;
    g[1] = r.ist2 * F0;
    g[2] = r.ist2 * (r.ct * F0 + mf * F1);
    g[NS - 1] = (mf * r.ct) * (r.ist2 * F1);
  }
}

// Shared memory of the synthesis kernel, in floats.
template <int C> struct SynthSmem {
  static constexpr int NROWS = 2 * NS * C + 4;  // fold rows, then the chains' ends
  static constexpr int A = 0;                   // a [LBK][BM]
  static constexpr int B = A + LBK * BM;        // b [LBK][BM]
  static constexpr int AS = B + LBK * BM;       // alm x stream [LBK][BM][C*NS]
  static constexpr int L = AS + LBK * BM * C * NS;  // folds [NROWS][BM][JP]
  static constexpr int SIZE = L + NROWS * BM * JP;
};

// K8a (scalar) / K8b: out[f, c, m, t] = sum over the degrees l >= LBK
// start[mb, tb] of u_f(l, m, theta_t) A[l, m, c], resumed from state.
// A [nl, nm, C]; ab [3, nl, nm] (a, b; the third table is not read);
// cs [NS, nl, nm]; state [3, nm, nt]; start [gridDim.y, gridDim.x];
// ctv [gridDim.x, JP]; W [gridDim.x, JP, BT]; cth [nt]; rows [4, nt];
// out [NFUN, C, nm, nt], written only on tiles with a blocked suffix.
template <int C>
__global__ void __launch_bounds__(NTHREADS)
blk_synthesis_kernel(const float* __restrict__ A, const float* __restrict__ ab,
                     const float* __restrict__ cs, const float* __restrict__ state,
                     const int* __restrict__ start, const float* __restrict__ ctv,
                     const float* __restrict__ W, const float* __restrict__ cth,
                     const float* __restrict__ rows, float* __restrict__ out, int nl, int nm,
                     int nt) {
  using S = SynthSmem<C>;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem + S::A;
  float* sb = smem + S::B;
  float* sAS = smem + S::AS;
  float* sL = smem + S::L;
  const int tb = blockIdx.x, mb = blockIdx.y;
  const int nlb = (nl + LBK - 1) / LBK;
  const int first = start[(size_t)mb * gridDim.x + tb];
  if (first >= nlb) return;  // uniform over the block
  const Who w;
  const int m0 = mb * BM, t0 = tb * BT;
  const float* __restrict__ Wt = W + (size_t)tb * JP * BT;
  const float ctj = ctv[(size_t)tb * JP + w.j];
  const RingRow ring = load_row(cth, rows, t0 + w.t, nt);
  const size_t nlm = (size_t)nl * nm;
  Entries st;
  load_entries(st, state, w, m0, t0, nm, nt);
  float acc[EPT][NFUN][C];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
#pragma unroll
    for (int f = 0; f < NFUN; ++f)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[e][f][c] = 0.0f;

  for (int il = first; il < nlb; ++il) {
    const int l0 = il * LBK;
    // no barrier needed here: the staged tables were last read in the build
    // of the block before, which ended at a barrier, and the folds are not
    // written before the next one
    stage_ab(sa, sb, ab, l0, m0, nl, nm, w.tid);
    for (int i = w.tid; i < LBK * BM * C * NS; i += NTHREADS) {
      const int s = i % NS, c = (i / NS) % C, km = i / (NS * C);
      const int l = l0 + km / BM, m = m0 + km % BM;
      const bool ok = l < nl && m < nm;
      const size_t lm = (size_t)l * nm + m;
      float v = ok ? A[lm * C + c] : 0.0f;
      if constexpr (MODE != SCALAR) v *= ok ? cs[s * nlm + lm] : 0.0f;
      sAS[i] = v;
    }
    __syncthreads();
    {  // build: the two value chains at this thread's node, and their folds
      float gAc = 1.0f, gAp = 0.0f, gBc = 0.0f, gBp = 1.0f;
      float fA[C * NS], fB[C * NS];
#pragma unroll
      for (int i = 0; i < C * NS; ++i) fA[i] = fB[i] = 0.0f;
      for (int k = 0; k < LBK; ++k) {
        const float a = sa[k * BM + w.mi], b = sb[k * BM + w.mi];
        const float gAn = a * (ctj * gAc - b * gAp);
        const float gBn = a * (ctj * gBc - b * gBp);
        gAp = gAc; gAc = gAn;
        gBp = gBc; gBc = gBn;
        const float* as = &sAS[(k * BM + w.mi) * C * NS];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float asn = as[c * NS + s];
            fA[c * NS + s] = fmaf(asn, fam_prev(s) ? gAp : gAc, fA[c * NS + s]);
            fB[c * NS + s] = fmaf(asn, fam_prev(s) ? gBp : gBc, fB[c * NS + s]);
          }
      }
      // fold rows of column c: its NS curr-family rows, then its NS prev-family rows
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          sL[((c * 2 * NS + s) * BM + w.mi) * JP + w.j] = fA[c * NS + s];
          sL[((c * 2 * NS + NS + s) * BM + w.mi) * JP + w.j] = fB[c * NS + s];
        }
      const int r0 = 2 * NS * C;
      sL[((r0 + 0) * BM + w.mi) * JP + w.j] = gAc;
      sL[((r0 + 1) * BM + w.mi) * JP + w.j] = gAp;
      sL[((r0 + 2) * BM + w.mi) * JP + w.j] = gBc;
      sL[((r0 + 3) * BM + w.mi) * JP + w.j] = gBp;
    }
    __syncthreads();
    // interpolate to the rings, emit from the entry state, then step it
    float currf[EPT], prevf[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const float fac = level_factor(st.lev[e]);
      currf[e] = st.curr[e] * fac;
      prevf[e] = st.prev[e] * fac;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float E[EPT][2 * NS];
      to_rings<2 * NS>(E, sL, c * 2 * NS, Wt, w);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        float ts[NS], u[NFUN];
#pragma unroll
        for (int s = 0; s < NS; ++s) ts[s] = E[e][s] * currf[e] + E[e][NS + s] * prevf[e];
        combine<MODE>(u, ts, ring, float(m0 + w.emi(e)));
#pragma unroll
        for (int f = 0; f < NFUN; ++f) acc[e][f][c] += u[f];
      }
    }
    float E2[EPT][4];
    to_rings<4>(E2, sL, 2 * NS * C, Wt, w);
    step_state(st, E2);
  }
  const size_t plane = (size_t)nm * nt;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int m = m0 + w.emi(e), t = t0 + w.t;
    if (m >= nm || t >= nt) continue;
#pragma unroll
    for (int f = 0; f < NFUN; ++f)
#pragma unroll
      for (int c = 0; c < C; ++c)
        out[((size_t)f * C + c) * plane + (size_t)m * nt + t] = acc[e][f][c];
  }
}

// Shared memory of the analysis kernel, in floats. The weighted ring data X
// of one column and the node-reduction slab share a region: X is dead once
// the rings are contracted, before the build fills the slab.
template <int C> struct AnalSmem {
  static constexpr int XSIZE = 2 * NS * BM * BT;    // X [2][NS][BM][BT]
  static constexpr int SLAB = KS * C * BM * JP;     // slab [KS][C][BM][JP]
  static constexpr int A = 0;                       // a [LBK][BM]
  static constexpr int B = A + LBK * BM;            // b [LBK][BM]
  static constexpr int CS = B + LBK * BM;           // streams [LBK][BM][NS]
  static constexpr int L = CS + LBK * BM * NS;      // the chains' ends [4][BM][JP]
  static constexpr int X = L + 4 * BM * JP;
  static constexpr int SIZE = X + (XSIZE > SLAB ? XSIZE : SLAB);
};

// K8c (scalar) / K8d: part[g, l, m, c] += sum over the rings t of the ring
// tiles tb of plane g that run l's block blocked (LBK start[mb, tb] <= l) of
// sum_f u_f(l, m, theta_t) F[f, c, m, t], resumed from state. F [NFUN, C, nm,
// nt]; WT [ntiles, BT, JP], the transpose of W; part [gridDim.x, nl, nm, C]
// zero on entry; the other arguments as in blk_synthesis_kernel, with start
// [gridDim.y, ntiles].
template <int C>
__global__ void __launch_bounds__(NTHREADS)
blk_analysis_kernel(const float* __restrict__ F, const float* __restrict__ ab,
                    const float* __restrict__ cs, const float* __restrict__ state,
                    const int* __restrict__ start, const float* __restrict__ ctv,
                    const float* __restrict__ WT, const float* __restrict__ cth,
                    const float* __restrict__ rows, float* __restrict__ part, int nl, int nm,
                    int nt, int ntiles) {
  using S = AnalSmem<C>;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem + S::A;
  float* sb = smem + S::B;
  float* scs = smem + S::CS;
  float* sL = smem + S::L;
  float* sX = smem + S::X;
  float* slab = smem + S::X;
  const int mb = blockIdx.y;
  const int nlb = (nl + LBK - 1) / LBK;
  const Who w;
  const int lane = w.tid & 31, warp = w.tid >> 5;
  const int m0 = mb * BM;
  const size_t nlm = (size_t)nl * nm;
  const size_t plane = (size_t)nm * nt;
  float* __restrict__ dst = part + (size_t)blockIdx.x * nl * nm * C;
  for (int tb = blockIdx.x; tb < ntiles; tb += gridDim.x) {
    const int first = start[(size_t)mb * ntiles + tb];
    if (first >= nlb) continue;  // uniform over the block
    const int t0 = tb * BT;
    const float* __restrict__ Wn = WT + (size_t)tb * BT * JP;
    const float ctj = ctv[(size_t)tb * JP + w.j];
    const RingRow ring = load_row(cth, rows, t0 + w.t, nt);
    Entries st;
    load_entries(st, state, w, m0, t0, nm, nt);
    for (int il = first; il < nlb; ++il) {
      const int l0 = il * LBK;
      __syncthreads();  // the slab and the tables of the block before are read
      stage_ab(sa, sb, ab, l0, m0, nl, nm, w.tid);
      if constexpr (MODE != SCALAR) {
        for (int i = w.tid; i < LBK * BM * NS; i += NTHREADS) {
          const int s = i % NS, km = i / NS;
          const int l = l0 + km / BM, m = m0 + km % BM;
          scs[i] = (l < nl && m < nm) ? cs[s * nlm + (size_t)l * nm + m] : 0.0f;
        }
      }
      // contract the rings first, a column at a time:
      // wc[c][s] = sum_t (curr fac g_s)(mi, t) W[j][t], wp likewise with prev
      float wc[C][NS], wp[C][NS];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c > 0) __syncthreads();  // X of the column before is read
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const int mi = w.emi(e), m = m0 + mi, t = t0 + w.t;
          const bool valid = m < nm && t < nt;
          const size_t mt = (size_t)m * nt + t;
          const float F0 = valid ? F[(size_t)c * plane + mt] : 0.0f;
          const float F1 = valid ? F[((size_t)(NFUN - 1) * C + c) * plane + mt] : 0.0f;
          const float fac = level_factor(st.lev[e]);
          const float currf = st.curr[e] * fac, prevf = st.prev[e] * fac;
          float g[NS];
          fields<MODE>(g, F0, F1, ring, float(m));
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            sX[((0 * NS + s) * BM + mi) * BT + w.t] = currf * g[s];
            sX[((1 * NS + s) * BM + mi) * BT + w.t] = prevf * g[s];
          }
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < NS; ++s) wc[c][s] = wp[c][s] = 0.0f;
        for (int t = 0; t < BT; t += 4) {
          float wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = Wn[(size_t)(t + q) * JP + w.j];
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float4 xc = *reinterpret_cast<const float4*>(
                &sX[((0 * NS + s) * BM + w.mi) * BT + t]);
            const float4 xp = *reinterpret_cast<const float4*>(
                &sX[((1 * NS + s) * BM + w.mi) * BT + t]);
            wc[c][s] = fmaf(xc.x, wv[0], wc[c][s]);
            wc[c][s] = fmaf(xc.y, wv[1], wc[c][s]);
            wc[c][s] = fmaf(xc.z, wv[2], wc[c][s]);
            wc[c][s] = fmaf(xc.w, wv[3], wc[c][s]);
            wp[c][s] = fmaf(xp.x, wv[0], wp[c][s]);
            wp[c][s] = fmaf(xp.y, wv[1], wp[c][s]);
            wp[c][s] = fmaf(xp.z, wv[2], wp[c][s]);
            wp[c][s] = fmaf(xp.w, wv[3], wp[c][s]);
          }
        }
      }
      __syncthreads();  // X is read: the slab may take its place
      // build: per degree the node sums' terms into the slab, reduced over
      // the nodes KS degrees at a time
      float gAc = 1.0f, gAp = 0.0f, gBc = 0.0f, gBp = 1.0f;
      for (int k = 0; k < LBK; ++k) {
        const float a = sa[k * BM + w.mi], b = sb[k * BM + w.mi];
        const float gAn = a * (ctj * gAc - b * gAp);
        const float gBn = a * (ctj * gBc - b * gBp);
        gAp = gAc; gAc = gAn;
        gBp = gBc; gBc = gBn;
        float cl[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s)
          cl[s] = MODE == SCALAR ? 1.0f : scs[(k * BM + w.mi) * NS + s];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float tot = 0.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s)
            tot += (fam_prev(s) ? gAp : gAc) * (cl[s] * wc[c][s]) +
                   (fam_prev(s) ? gBp : gBc) * (cl[s] * wp[c][s]);
          slab[(((k % KS) * C + c) * BM + w.mi) * JP + w.j] = tot;
        }
        if (k % KS == KS - 1) {
          __syncthreads();
          // one warp per (degree, column, m row): the same warp owns the same
          // (l, m, c) entry in every tile, so the += needs no atomics
          for (int r = warp; r < KS * C * BM; r += NTHREADS / 32) {
            const float4 v = *reinterpret_cast<const float4*>(&slab[(size_t)r * JP + lane * 4]);
            const float sum = warp_sum((v.x + v.y) + (v.z + v.w));
            const int mi = r % BM, c = (r / BM) % C, l = l0 + k - (KS - 1) + r / (BM * C);
            if (lane == 0 && l < nl && m0 + mi < nm)
              dst[((size_t)l * nm + m0 + mi) * C + c] += sum;
          }
          __syncthreads();
        }
      }
      // step the state over the block
      sL[(0 * BM + w.mi) * JP + w.j] = gAc;
      sL[(1 * BM + w.mi) * JP + w.j] = gAp;
      sL[(2 * BM + w.mi) * JP + w.j] = gBc;
      sL[(3 * BM + w.mi) * JP + w.j] = gBp;
      __syncthreads();
      float E2[EPT][4];
      // W[j][t] = WT[t][j]
#pragma unroll
      for (int e = 0; e < EPT; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) E2[e][r] = 0.0f;
      for (int j = 0; j < JP; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&Wn[(size_t)w.t * JP + j]);
#pragma unroll
        for (int e = 0; e < EPT; ++e)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 l = *reinterpret_cast<const float4*>(
                &sL[((size_t)r * BM + w.emi(e)) * JP + j]);
            E2[e][r] = fmaf(l.x, wv.x, E2[e][r]);
            E2[e][r] = fmaf(l.y, wv.y, E2[e][r]);
            E2[e][r] = fmaf(l.z, wv.z, E2[e][r]);
            E2[e][r] = fmaf(l.w, wv.w, E2[e][r]);
          }
      }
      step_state(st, E2);
    }
  }
}

template <int C>
int launch_blk_synthesis(const float* A, const float* ab, const float* cs, const float* state,
                         const int* start, const float* ctv, const float* W, const float* cth,
                         const float* rows, float* out, int nl, int nm, int nt,
                         cudaStream_t st) {
  const size_t bytes = SynthSmem<C>::SIZE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blk_synthesis_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nt + BT - 1) / BT, (nm + BM - 1) / BM);
  blk_synthesis_kernel<C><<<grid, NTHREADS, bytes, st>>>(A, ab, cs, state, start, ctv, W, cth,
                                                         rows, out, nl, nm, nt);
  return (int)cudaGetLastError();
}

template <int C>
int launch_blk_analysis(const float* F, const float* ab, const float* cs, const float* state,
                        const int* start, const float* ctv, const float* WT, const float* cth,
                        const float* rows, float* part, int nl, int nm, int nt, int nplanes,
                        cudaStream_t st) {
  const size_t bytes = AnalSmem<C>::SIZE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blk_analysis_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nt + BT - 1) / BT;
  if (nplanes < 1 || nplanes > ntiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(nplanes, (nm + BM - 1) / BM);
  blk_analysis_kernel<C><<<grid, NTHREADS, bytes, st>>>(F, ab, cs, state, start, ctv, WT, cth,
                                                        rows, part, nl, nm, nt, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define FP(x) static_cast<const float*>(x)

// C (2 or 4) is the coefficient count. All tensors are float32 but start
// (int32); the shapes are those of the kernels' comments.
extern "C" int PT_ENTRY(pt_blk_synthesis)(int C, const void* A, const void* ab, const void* cs,
                                          const void* state, const void* start,
                                          const void* ctv, const void* W, const void* cth,
                                          const void* rows, void* out, int nl, int nm, int nt,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || nm <= 0 || nt <= 0) return 0;
  const int* s0 = static_cast<const int*>(start);
  float* o = static_cast<float*>(out);
  switch (C) {
    case 2:
      return launch_blk_synthesis<2>(FP(A), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(W),
                                     FP(cth), FP(rows), o, nl, nm, nt, st);
    case 4:
      return launch_blk_synthesis<4>(FP(A), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(W),
                                     FP(cth), FP(rows), o, nl, nm, nt, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int PT_ENTRY(pt_blk_analysis)(int C, const void* F, const void* ab, const void* cs,
                                         const void* state, const void* start,
                                         const void* ctv, const void* WT, const void* cth,
                                         const void* rows, void* part, int nl, int nm, int nt,
                                         int nplanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || nm <= 0 || nt <= 0) return 0;
  const int* s0 = static_cast<const int*>(start);
  float* p = static_cast<float*>(part);
  switch (C) {
    case 2:
      return launch_blk_analysis<2>(FP(F), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(WT),
                                    FP(cth), FP(rows), p, nl, nm, nt, nplanes, st);
    case 4:
      return launch_blk_analysis<4>(FP(F), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(WT),
                                    FP(cth), FP(rows), p, nl, nm, nt, nplanes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Tile sizes, so the host can size the tables and the partial planes.
extern "C" int PT_ENTRY(pt_blk_tile_theta)() { return BT; }
extern "C" int PT_ENTRY(pt_blk_tile_m)() { return BM; }
extern "C" int PT_ENTRY(pt_blk_degrees)() { return LBK; }
extern "C" int PT_ENTRY(pt_blk_nodes)() { return JP; }
