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
// What bounds these kernels on an H100. Per m row and 112-degree block the
// build costs 128 x 112 x 6 FP32 operations; the rest is products: the node
// -> ring product 2 x (2 NS C + 4) x 128 x BT (synthesis), and in analysis
// the ring -> node contraction 2 x 2 NS C x 128 x BT, the per-degree node
// sums 2 x 2 x 128 x NS C x 112 and the chain-end product 2 x 4 x 128 x BT.
// The TPU gave the products to its matrix unit at full float32 precision
// (Precision.HIGHEST, :970-979). No --use_fast_math.
// blk_synthesis_kernel: one CUDA block owns one (m tile, ring tile) pair of
// BM = 4 m rows by BT = 256 rings and loops over its 112-degree blocks from
// its start block to the last, with the recurrence state of its 1024
// entries in registers (the TPU's sequential third grid axis and its VMEM
// scratch). Each of the 512 threads plays two parts: in the build it owns
// one (m row, node), in the product and the state update two (m row, ring)
// entries, the same ring in two m rows, so one W value serves both. a, b,
// the alm times the stream coefficients and the node folds live in dynamic
// shared memory (up to ~104 KB, spin2 with C = 4); W is read from global
// memory, where all m tiles of a ring tile share it through L2. The
// products run on the CUDA cores with FP32 FMAs.
// blk_analysis_kernel puts its three products on the tensor cores in
// 3xTF32 (mma.sync, float32 accuracy at a third of the TF32 rate) and keeps
// only the build on the CUDA cores: see its comment. Like K4 it writes
// partial sums per plane of ring tiles into a zeroed [planes, nl, nm, C]
// buffer that is summed afterwards: no atomics.
//
// Every extern "C" entry point launches on the given stream, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

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
static_assert(NTHREADS % BT == 0 && EPT * (NTHREADS / BT) == BM &&
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

// One step of the two value chains at a node: gX_n = a (ct gX_c - b gX_p).
__device__ __forceinline__ void chain_step(float& gAc, float& gAp, float& gBc, float& gBp,
                                           float a, float b, float ct) {
  const float gAn = a * (ct * gAc - b * gAp);
  const float gBn = a * (ct * gBc - b * gBp);
  gAp = gAc;
  gAc = gAn;
  gBp = gBc;
  gBc = gBn;
}

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
                                         int l0, int m0, int nl, int nm, int tid,
                                         int nthreads = NTHREADS) {
  const size_t nlm = (size_t)nl * nm;
  for (int i = tid; i < LBK * BM; i += nthreads) {
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

// ---------------------------------------------------------------------------
// The analysis kernel's products on the tensor cores, in 3xTF32
// ---------------------------------------------------------------------------
// mma.sync m16n8k8 with TF32 operands and FP32 accumulators. An operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and a product takes
// lo*hi + hi*lo + hi*hi: about float32's accuracy (the dropped lo*lo is
// 2^-22 of the product), where one TF32 pass keeps 2^-11. Fragments (PTX
// ISA, m16n8k8 .tf32), lane = 4 g + q: A[16 x 8] row-major holds (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4); B[8 x 8] holds (k q, n g),
// (k q + 4, n g); the accumulator (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).

// x rounded to TF32 (10 mantissa bits; ties away from zero), as its bits
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, not through registers
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// hi, lo of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// a b in 3xTF32: d += hi*hi, e += lo*hi + hi*lo. Separate accumulators
// give the tensor cores independent chains, where one chain of dependent
// mma.sync would wait out the unit's latency at every step: the state step
// and the node sums keep a (d, e) pair for even and one for odd k-steps,
// the contraction a pair per tile where a warp has few tiles (scalar).
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(e, al, bh);
  mma_tf32(e, ah, bl);
  mma_tf32(d, ah, bh);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.0f;
}

// The A fragment of the 16 x 8 tile at (r0, k0) of a row-major matrix with
// rows of ld floats: from a pre-split pair (hi, lo) of matrices, or from one
// float32 matrix split here.
__device__ __forceinline__ void frag_a(uint32_t (&h)[4], uint32_t (&l)[4], const float* H,
                                       const float* L, int ld, int r0, int k0, int lane) {
  const int i = (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  const int o[4] = {0, 8 * ld, 4, 8 * ld + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = __float_as_uint(H[i + o[e]]);
    l[e] = __float_as_uint(L[i + o[e]]);
  }
}

__device__ __forceinline__ void frag_a(uint32_t (&h)[4], uint32_t (&l)[4], const float* M,
                                       int ld, int r0, int k0, int lane) {
  const int i = (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  const int o[4] = {0, 8 * ld, 4, 8 * ld + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) split(M[i + o[e]], h[e], l[e]);
}

// The B fragment of the 8 x 8 tile at (k0, n0) of B stored as its
// transpose [n][k] (rows of ld floats), pre-split; and from one float32
// matrix split here, where columns n >= nmax read as zero.
__device__ __forceinline__ void frag_bt(uint32_t (&h)[2], uint32_t (&l)[2], const float* H,
                                        const float* L, int ld, int k0, int n0, int lane) {
  const int i = (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  h[0] = __float_as_uint(H[i]);
  h[1] = __float_as_uint(H[i + 4]);
  l[0] = __float_as_uint(L[i]);
  l[1] = __float_as_uint(L[i + 4]);
}

__device__ __forceinline__ void frag_bt(uint32_t (&h)[2], uint32_t (&l)[2], const float* M,
                                        int ld, int k0, int n0, int nmax, int lane) {
  const int n = n0 + (lane >> 2), i = n * ld + k0 + (lane & 3);
  split(n < nmax ? M[i] : 0.0f, h[0], l[0]);
  split(n < nmax ? M[i + 4] : 0.0f, h[1], l[1]);
}

// ... and of B stored as is, [k][n], pre-split
__device__ __forceinline__ void frag_b(uint32_t (&h)[2], uint32_t (&l)[2], const float* H,
                                       const float* L, int ld, int k0, int n0, int lane) {
  const int i = (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  h[0] = __float_as_uint(H[i]);
  h[1] = __float_as_uint(H[i + 4 * ld]);
  l[0] = __float_as_uint(L[i]);
  l[1] = __float_as_uint(L[i + 4 * ld]);
}

constexpr int ANT = 256;         // threads of the analysis kernel
constexpr int AWARPS = ANT / 32;
constexpr int TS = 64;           // rings per slab of the ring loop
constexpr int KR = 16;           // degrees per slab of the build
constexpr int LDW = TS + 4;      // row strides in shared memory, padded so that
constexpr int LDJ = 2 * JP + 4;  // the fragments' 32 loads fall in 32 banks
constexpr int LDE = JP + 4;
static_assert(BT % TS == 0 && LBK % KR == 0 && KR == 16 && TS == 8 * AWARPS &&
                  BM * TS == ANT && BM * JP == 2 * ANT && AWARPS == 2 * BM,
              "analysis tiles");
constexpr bool HAS_PREV = NS > 1;  // a mode with a stream of the previous chain value

// Shared memory of the analysis kernel, in floats. The ring loop's slabs
// (W, X) and the build's (node sums' B operand, chains, partial sums) share
// one region U; the rest lives through a whole block of degrees. Scalar
// mode at C = 2 (106 KB, no streams or previous-chain sums) fits two
// blocks an SM.
template <int C> struct AnalSmem {
  static constexpr int NSC = NS * C;            // (column, stream) pairs
  static constexpr int R = 2 * NSC * BM;        // rows (curr|prev, c, s, m row) of X
  static constexpr int NP = (NSC + 7) / 8 * 8;  // node-sum columns, whole n-tiles
  static constexpr int A = 0;                   // a [LBK][BM]
  static constexpr int B = A + LBK * BM;        // b [LBK][BM]
  static constexpr int CS = B + LBK * BM;       // streams [LBK][BM][NS] (not in scalar)
  static constexpr int PREV = CS + (MODE == SCALAR ? 0 : LBK * BM * NS);  // state: prev [BM][BT]
  static constexpr int CURR = PREV + BM * BT;      //        curr [BM][BT]
  static constexpr int LEV = CURR + BM * BT;       //        level [BM][BT]
  static constexpr int OC = LEV + BM * BT;      // curr-family sums [LBK][BM][C]
  static constexpr int OP = OC + LBK * BM * C;  // prev-family sums [LBK][BM][C], if any
  static constexpr int EH = OP + (HAS_PREV ? LBK * BM * C : 0);  // chain ends [16][LDE],
  static constexpr int U = EH + 16 * LDE;                          // rows (end, m row)
  // the ring loop: W hi, lo [JP][LDW] of TS rings; X hi, lo [R][LDW]
  static constexpr int WH = U, WL = WH + JP * LDW, XH = WL + JP * LDW, XL = XH + R * LDW;
  // the build: Wc|Wp [BM][NSC][LDJ] (j of Wc, then of Wp); chains [BM][KR][LDJ]
  // (gA, then gB); partial node sums [2][BM][KR][NP]
  static constexpr int BW = U, CH = BW + BM * NSC * LDJ, P = CH + BM * KR * LDJ;
  static constexpr int UEND_RING = XL + R * LDW, UEND_BUILD = P + 2 * BM * KR * NP;
  static constexpr int SIZE = UEND_RING > UEND_BUILD ? UEND_RING : UEND_BUILD;
  static_assert(SIZE * 4 <= 232448, "shared memory");
  static_assert(WH % 4 == 0 && WL % 4 == 0, "cp.async destinations align to 16 bytes");
};

// K8c (scalar) / K8d: part[g, l, m, c] (+)= sum over the rings t of the ring
// tiles tb of plane g that run l's block blocked (LBK start[mb, tb] <= l) of
// sum_f u_f(l, m, theta_t) F[f, c, m, t], resumed from state. F [NFUN, C, nm,
// nt]; Wtf [2, ntiles, JP, BT], W split into TF32 hi and lo; part [gridDim.x,
// nl, nm, C] zero on entry, stored to where a plane holds one ring tile and
// added to otherwise; the other arguments as in blk_synthesis_kernel, with
// start [gridDim.y, ntiles].
//
// One block of 256 threads owns BM = 4 m rows and, in turn, the ring tiles
// of its plane. Per 112-degree block, three phases:
// 1. rings -> nodes, over slabs of TS = 64 rings: the slab of W (hi, lo) by
//    cp.async; the state step of the block before, E = ends W (16 rows:
//    gA_c, gA_p, gB_c, gB_p of each m row; one warp per 8 rings, K = the 128
//    nodes), renormalized in the accumulators' lanes; the fields times the
//    state's values X (hi, lo; rows (curr|prev, c, s, m row)); and
//    Wc|Wp += X W^T, R x 128 accumulators kept in the warps' registers.
// 2. the build, over slabs of KR = 16 degrees: each thread steps the chains
//    of two (m row, node) pairs in FP32 and stores them; each warp takes one
//    m row and one half of the 256 (gA node, gB node) terms and multiplies
//    the chains [16 degrees x 128] by Wc|Wp [128 x (c, s)]; the two halves
//    meet in shared memory, where the stream coefficients weigh them into
//    the degrees' sums. A stream of the previous chain value reads chain
//    row k - 1, so its product goes to degree k + 1; degree 0 takes the row
//    before the block (gA = 1, gB = 0), the sum of Wc over the nodes.
//    Scalar mode (NS C = 2) fills a quarter of the 8-column n-tile and
//    takes it all the same: FP32 sums of the same terms reduced by warp
//    shuffles (a reduce-scatter over the 32 nodes of a warp) took longer on
//    the card, the shuffles being the slow part.
// 3. the block's [LBK, BM, C] sums reach the partial plane once.
template <int C>
__global__ void __launch_bounds__(ANT, MODE == SCALAR ? 2 : 1)
blk_analysis_kernel(const float* __restrict__ F, const float* __restrict__ ab,
                    const float* __restrict__ cs, const float* __restrict__ state,
                    const int* __restrict__ start, const float* __restrict__ ctv,
                    const float* __restrict__ Wtf, const float* __restrict__ cth,
                    const float* __restrict__ rows, float* __restrict__ part, int nl, int nm,
                    int nt, int ntiles) {
  using S = AnalSmem<C>;
  constexpr int NSC = S::NSC, R = S::R, NP = S::NP;
  constexpr int MT = R / 16;                    // m-tiles of X
  constexpr int WM = MT >= 8 ? 2 : 1;           // warps along them
  constexpr int MTW = MT / WM, NTJ = JP / 8 / (AWARPS / WM);  // tiles of a warp
  constexpr int NTP = NP / 8;                   // n-tiles of the node sums
  static_assert(R % 16 == 0 && MT % WM == 0, "X tiles");
  extern __shared__ __align__(16) float smem[];
  float* sa = smem + S::A;
  float* sb = smem + S::B;
  float* scs = smem + S::CS;
  float* sprev = smem + S::PREV;
  float* scurr = smem + S::CURR;
  float* slev = smem + S::LEV;
  float* oc = smem + S::OC;
  float* op = smem + S::OP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mb = blockIdx.y, m0 = mb * BM;
  const int nlb = (nl + LBK - 1) / LBK;
  const size_t nlm = (size_t)nl * nm, plane = (size_t)nm * nt;
  const float* __restrict__ Wlo = Wtf + (size_t)ntiles * JP * BT;
  float* __restrict__ dst = part + (size_t)blockIdx.x * nl * nm * C;
  const bool store = ntiles <= (int)gridDim.x;  // each plane holds one ring tile
  for (int tb = blockIdx.x; tb < ntiles; tb += gridDim.x) {
    const int first = start[(size_t)mb * ntiles + tb];
    if (first >= nlb) continue;  // uniform over the block
    const int t0 = tb * BT;
    const float* __restrict__ Wh = Wtf + (size_t)tb * JP * BT;
    const float* __restrict__ Wl = Wlo + (size_t)tb * JP * BT;
    __syncthreads();  // the tile before is done with the state
    for (int i = tid; i < BM * BT; i += ANT) {
      const int m = m0 + i / BT, t = t0 + i % BT;
      const bool valid = m < nm && t < nt;
      const size_t mt = (size_t)m * nt + t;
      sprev[i] = valid ? state[mt] : 0.0f;
      scurr[i] = valid ? state[plane + mt] : 0.0f;
      slev[i] = valid ? state[2 * plane + mt] : 0.0f;
    }
    for (int il = first; il < nlb; ++il) {
      const int l0 = il * LBK;
      __syncthreads();  // the state is loaded; the block before is read
      stage_ab(sa, sb, ab, l0, m0, nl, nm, tid, ANT);
      if constexpr (MODE != SCALAR) {
        for (int i = tid; i < LBK * BM * NS; i += ANT) {
          const int s = i % NS, km = i / NS;
          const int l = l0 + km / BM, m = m0 + km % BM;
          scs[i] = (l < nl && m < nm) ? cs[s * nlm + (size_t)l * nm + m] : 0.0f;
        }
      }
      // ---- 1. rings -> nodes ----
      // the correction terms in accumulators of their own where a warp has
      // few tiles (scalar), else with the main term
      constexpr int NCORR = MTW * NTJ <= 4 ? MTW * NTJ : 1;
      float acc[MTW * NTJ][4], corr[NCORR][4];
      zero(acc);
      zero(corr);
      for (int ts = 0; ts < BT; ts += TS) {
        float* sWH = smem + S::WH;
        float* sWL = smem + S::WL;
        float* sXH = smem + S::XH;
        float* sXL = smem + S::XL;
        for (int i = tid; i < 2 * JP * (TS / 4); i += ANT) {
          const int lo = i / (JP * (TS / 4)), j = (i / (TS / 4)) % JP, c4 = (i % (TS / 4)) * 4;
          cp_async16((lo ? sWL : sWH) + j * LDW + c4, (lo ? Wl : Wh) + (size_t)j * BT + ts + c4);
        }
        cp_async_wait_all();
        __syncthreads();
        if (il > first) {
          // the state step of block il - 1 on this slab's rings: warp w takes
          // rings ts + 8w .. +7; accumulator rows g and g + 8 are the ends
          // (gA_c, gB_c) of m row g for g < 4, (gA_p, gB_p) of m row g - 4 else
          float ed[2][4], ee[2][4], e4[4];
          zero(ed);
          zero(ee);
#pragma unroll
          for (int k0 = 0; k0 < JP; k0 += 8) {
            uint32_t ah[4], al[4], bh[2], bl[2];
            frag_a(ah, al, smem + S::EH, LDE, 0, k0, lane);
            frag_b(bh, bl, sWH, sWL, LDW, k0, warp * 8, lane);
            mma3(ed[(k0 >> 3) & 1], ee[(k0 >> 3) & 1], ah, al, bh, bl);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) e4[e] = (ee[0][e] + ee[1][e]) + (ed[0][e] + ed[1][e]);
          const bool lower = g < 4;
          const int mi = g & 3;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = mi * BT + ts + warp * 8 + 2 * q + h;
            const float mine = e4[h] * scurr[i] + e4[2 + h] * sprev[i];  // nc, or np
            const float other = __shfl_xor_sync(0xffffffffu, mine, 16);
            const float nc = lower ? mine : other, np = lower ? other : mine;
            const bool big = fabsf(nc) > band();
            if (lower) {
              scurr[i] = big ? nc * invband() : nc;
              if (big) slev[i] += 1.0f;
            } else {
              sprev[i] = big ? np * invband() : np;
            }
          }
          __syncthreads();
        }
        {  // X: thread (m row, ring) of the slab
          const int mi = tid / TS, tt = tid % TS, i = mi * BT + ts + tt;
          const int m = m0 + mi, t = t0 + ts + tt;
          const bool valid = m < nm && t < nt;
          const size_t mt = (size_t)m * nt + t;
          const float fac = level_factor((int)slev[i]);
          const float cf = scurr[i] * fac, pf = sprev[i] * fac;
          const RingRow ring = load_row(cth, rows, t, nt);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float F0 = valid ? F[(size_t)c * plane + mt] : 0.0f;
            const float F1 = valid ? F[((size_t)(NFUN - 1) * C + c) * plane + mt] : 0.0f;
            float gs[NS];
            fields<MODE>(gs, F0, F1, ring, float(m));
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const int r0 = (c * NS + s) * BM + mi, r1 = ((NSC + c * NS + s) * BM) + mi;
              uint32_t h, l;
              split(cf * gs[s], h, l);
              sXH[r0 * LDW + tt] = __uint_as_float(h);
              sXL[r0 * LDW + tt] = __uint_as_float(l);
              split(pf * gs[s], h, l);
              sXH[r1 * LDW + tt] = __uint_as_float(h);
              sXL[r1 * LDW + tt] = __uint_as_float(l);
            }
          }
        }
        __syncthreads();
        {  // Wc|Wp += X W^T: warp (wm, wn) takes m-tiles wm MTW.., n-tiles wn NTJ..
          const int wm = warp / (AWARPS / WM), wn = warp % (AWARPS / WM);
#pragma unroll 2
          for (int k0 = 0; k0 < TS; k0 += 8) {
            uint32_t bh[NTJ][2], bl[NTJ][2];
#pragma unroll
            for (int b = 0; b < NTJ; ++b)
              frag_bt(bh[b], bl[b], sWH, sWL, LDW, k0, (wn * NTJ + b) * 8, lane);
#pragma unroll
            for (int a = 0; a < MTW; ++a) {
              uint32_t ah[4], al[4];
              frag_a(ah, al, sXH, sXL, LDW, (wm * MTW + a) * 16, k0, lane);
#pragma unroll
              for (int b = 0; b < NTJ; ++b) {
                const int i = a * NTJ + b;
                if constexpr (NCORR > 1)
                  mma3(acc[i], corr[i], ah, al, bh[b], bl[b]);
                else
                  mma3(acc[i], acc[i], ah, al, bh[b], bl[b]);
              }
            }
          }
        }
        __syncthreads();  // the slabs are read
      }
      {  // Wc|Wp to shared memory as the node sums' B operand: [m row][(c, s)][(half, node)]
        float* sBW = smem + S::BW;
        const int wm = warp / (AWARPS / WM), wn = warp % (AWARPS / WM);
#pragma unroll
        for (int a = 0; a < MTW; ++a)
#pragma unroll
          for (int b = 0; b < NTJ; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = (wm * MTW + a) * 16 + g + (e >> 1) * 8;
              const int j = (wn * NTJ + b) * 8 + 2 * q + (e & 1);
              const int mi = r % BM, n = (r / BM) % NSC, half = r / (BM * NSC);
              const int i = a * NTJ + b;
              float v = acc[i][e];
              if constexpr (NCORR > 1) v += corr[i][e];
              sBW[(mi * NSC + n) * LDJ + half * JP + j] = v;
            }
      }
      __syncthreads();
      if constexpr (HAS_PREV) {
        // degree 0 of the previous-chain streams: the row before the block,
        // sum over the nodes of Wc (one warp per (m row, column))
        const float* sBW = smem + S::BW;
        for (int p = warp; p < BM * C; p += AWARPS) {
          const int mi = p / C, c = p % C;
          float tot = 0.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if (!fam_prev(s)) continue;
            const float* row = sBW + (mi * NSC + c * NS + s) * LDJ;
            const float v = warp_sum((row[lane] + row[lane + 32]) + (row[lane + 64] + row[lane + 96]));
            tot += scs[mi * NS + s] * v;
          }
          if (lane == 0) op[mi * C + c] = tot;
        }
      }
      // ---- 2. the build ----
      const int j = tid % JP, mi0 = tid / JP;  // m rows mi0 and mi0 + 2
      const float ctj = ctv[(size_t)tb * JP + j];
      float gAc[2] = {1.0f, 1.0f}, gAp[2] = {0.0f, 0.0f}, gBc[2] = {0.0f, 0.0f},
            gBp[2] = {1.0f, 1.0f};
      for (int k0 = 0; k0 < LBK; k0 += KR) {
        float* sCH = smem + S::CH;
        float* sP = smem + S::P;
        const float* sBW = smem + S::BW;
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int mi = mi0 + 2 * p;
            chain_step(gAc[p], gAp[p], gBc[p], gBp[p], sa[(k0 + kk) * BM + mi],
                       sb[(k0 + kk) * BM + mi], ctj);
            sCH[(mi * KR + kk) * LDJ + j] = gAc[p];
            sCH[(mi * KR + kk) * LDJ + JP + j] = gBc[p];
          }
        }
        __syncthreads();
        {  // warp (m row, half): the slab's chains against Wc (half 0) or Wp (half 1)
          const int mi = warp >> 1, half = warp & 1;
          float dd[2 * NTP][4], de[2 * NTP][4], d[NTP][4];
          zero(dd);
          zero(de);
#pragma unroll
          for (int k8 = 0; k8 < JP; k8 += 8) {
            const int kj = half * JP + k8, h = (k8 >> 3) & 1;
            uint32_t ah[4], al[4];
            frag_a(ah, al, sCH + mi * KR * LDJ, LDJ, 0, kj, lane);
#pragma unroll
            for (int b = 0; b < NTP; ++b) {
              uint32_t bh[2], bl[2];
              frag_bt(bh, bl, sBW + mi * NSC * LDJ, LDJ, kj, b * 8, NSC, lane);
              mma3(dd[2 * b + h], de[2 * b + h], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int b = 0; b < NTP; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              d[b][e] = (de[2 * b][e] + de[2 * b + 1][e]) + (dd[2 * b][e] + dd[2 * b + 1][e]);
#pragma unroll
          for (int b = 0; b < NTP; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sP[((half * BM + mi) * KR + g + (e >> 1) * 8) * NP + b * 8 + 2 * q + (e & 1)] =
                  d[b][e];
        }
        __syncthreads();
        // the degrees' sums: thread (degree, m row, column)
        for (int i = tid; i < KR * BM * C; i += ANT) {
          const int kk = i / (BM * C), mi = (i / C) % BM, c = i % C, k = k0 + kk;
          const float* p0 = sP + (mi * KR + kk) * NP + c * NS;
          const float* p1 = p0 + BM * KR * NP;
          float vc = 0.0f, vp = 0.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float Q = p0[s] + p1[s];
            if (!fam_prev(s))
              vc += (MODE == SCALAR ? 1.0f : scs[(k * BM + mi) * NS + s]) * Q;
            else if (k + 1 < LBK)
              vp += scs[((k + 1) * BM + mi) * NS + s] * Q;
          }
          oc[(k * BM + mi) * C + c] = vc;
          if (HAS_PREV && k + 1 < LBK) op[((k + 1) * BM + mi) * C + c] = vp;
        }
      }
      // the chains' ends, the A operand of the next block's state step
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int mi = mi0 + 2 * p;
        const float ends[4] = {gAc[p], gAp[p], gBc[p], gBp[p]};
#pragma unroll
        for (int r = 0; r < 4; ++r) smem[S::EH + (r * BM + mi) * LDE + j] = ends[r];
      }
      __syncthreads();
      // ---- 3. the block's sums to the partial plane ----
      for (int i = tid; i < LBK * BM * C; i += ANT) {
        const int k = i / (BM * C), mi = (i / C) % BM, c = i % C;
        const int l = l0 + k, m = m0 + mi;
        if (l >= nl || m >= nm) continue;
        const float v = oc[i] + (HAS_PREV ? op[i] : 0.0f);
        float* o = dst + ((size_t)l * nm + m) * C + c;
        *o = store ? v : *o + v;
      }
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
                        const int* start, const float* ctv, const float* Wtf, const float* cth,
                        const float* rows, float* part, int nl, int nm, int nt, int nplanes,
                        cudaStream_t st) {
  const size_t bytes = AnalSmem<C>::SIZE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blk_analysis_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nt + BT - 1) / BT;
  if (nplanes < 1 || nplanes > ntiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(nplanes, (nm + BM - 1) / BM);
  blk_analysis_kernel<C><<<grid, ANT, bytes, st>>>(F, ab, cs, state, start, ctv, Wtf, cth, rows,
                                                   part, nl, nm, nt, ntiles);
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
                                         const void* ctv, const void* Wtf, const void* cth,
                                         const void* rows, void* part, int nl, int nm, int nt,
                                         int nplanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || nm <= 0 || nt <= 0) return 0;
  const int* s0 = static_cast<const int*>(start);
  float* p = static_cast<float*>(part);
  switch (C) {
    case 2:
      return launch_blk_analysis<2>(FP(F), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(Wtf),
                                    FP(cth), FP(rows), p, nl, nm, nt, nplanes, st);
    case 4:
      return launch_blk_analysis<4>(FP(F), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(Wtf),
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
