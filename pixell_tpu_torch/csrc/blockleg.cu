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
// build costs 128 x 112 x 6 FP32 operations (synthesis adds its folds, 4 NS
// C per node and degree); the rest is products: the node
// -> ring product 2 x (2 NS C + 4) x 128 x BT (synthesis), and in analysis
// the ring -> node contraction 2 x 2 NS C x 128 x BT, the per-degree node
// sums 2 x 2 x 128 x NS C x 112 and the chain-end product 2 x 4 x 128 x BT.
// The TPU gave the products to its matrix unit at full float32 precision
// (Precision.HIGHEST, :970-979). No --use_fast_math.
// blk_synthesis_kernel puts its node -> ring product on the tensor cores in
// 3xTF32 (wgmma, W resident in shared memory, the folds handed over by
// producer warpgroups that build the next round meanwhile): see its
// comment.
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
static_assert(JP == 128 && BT % 64 == 0 && BM == 4, "tile sizes");

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

// Stage a_lm, b_lm of degrees l0 .. l0+LBK-1 for the tile's m rows into
// sa, sb [LBK][BM]; zero outside the tables, which ends the chains there.
__device__ __forceinline__ void stage_ab(float* sa, float* sb, const float* __restrict__ ab,
                                         int l0, int m0, int nl, int nm, int tid,
                                         int nthreads) {
  const size_t nlm = (size_t)nl * nm;
  for (int i = tid; i < LBK * BM; i += nthreads) {
    const int l = l0 + i / BM, m = m0 + i % BM;
    const bool ok = l < nl && m < nm;
    const size_t lm = (size_t)l * nm + m;
    sa[i] = ok ? ab[lm] : 0.0f;
    sb[i] = ok ? ab[nlm + lm] : 0.0f;
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

// ---------------------------------------------------------------------------
// The synthesis kernel: the node -> ring product on the tensor cores (wgmma,
// 3xTF32), the build in producer warpgroups beside it
// ---------------------------------------------------------------------------
// K8a (scalar) / K8b: out[f, c, m, t] = sum over the degrees l >= LBK
// start[mb, tb] of u_f(l, m, theta_t) A[l, m, c], resumed from state.
// A [nl, nm, C]; ab [3, nl, nm] (a, b; the third table is not read);
// cs [NS, nl, nm]; state [3, nm, nt]; start [gridDim.y, gridDim.x];
// ctv [gridDim.x, JP]; Wf [gridDim.x, BT / 64, JP / 8, 128, 4], W in the
// order of the wgmma A fragments (ops/sht_cuda.py blk_w_fragments); cth
// [nt]; rows [4, nt]; out [NFUN, C, nm, nt], written only on tiles with a
// blocked suffix.
//
// One block of 512 threads owns BM = 4 m rows by BT = 256 rings and runs
// C / 2 passes over their 112-degree blocks, two columns each; a round is
// one block of one pass. (At C = 4 the second pass steps the chains again,
// 6 of the 6 + 4 NS C operations per node and degree, and holds two
// columns' sums in registers where one pass would hold four.)
// - Warpgroups 0 and 1, the producers: thread p steps the two value chains
//   at node p % 128 for two m rows and folds them against the round's alm x
//   stream coefficients (FP32 FMAs), in registers; its tables arrive by
//   cp.async a slab of degrees ahead. It then waits until the consumers
//   have read the round before, writes the fold rows and the chains' four
//   ends into the fold buffer, split into TF32 hi and lo, and goes on with
//   the next round's build while the consumers work.
// - Warpgroups 2 and 3, the consumers, own 128 rings each as two 64-ring
//   tiles. Per tile, D [64 rings x N] = W^T [64 x 128 nodes] B [128 x N]
//   over the N = BM R columns (m row, row type), R = 2 NS 2 fold rows and
//   the four ends: 16 k-steps of three wgmma.m64nNk8 (lo hi, hi lo, hi hi),
//   A = W^T from registers, split there from float32, B = the folds from
//   shared memory. The epilogue stays in the accumulators: emission from the
//   state, combine, the state step and its renormalization, in FP32.
//   Column n = 8 (r / 2) + 2 mi + (r & 1) holds row type r of m row mi, so
//   lane 4 g + q's accumulators (columns 8 i + 2 q + {0, 1}, rings g and
//   g + 8 of its warp's 16) hold every row its two (m row q, ring) entries
//   need.
// W [256 x 128] float32 stays in shared memory for the block's life (128
// KB, one bulk TMA copy; in fragment order each thread reads a float4 per
// k-step, conflict-free). Split W would take 256 KB, and streaming it per
// degree block would read 256 KB from L2 per block and degree block.
// What bounds it: the build's FP32 FMAs (the producers) against the
// products' TF32 issue (the consumers), overlapped; one block per SM. It
// reaches 43-51 % of that bound on an NVIDIA H100 80GB HBM3 at 700 W, both
// roles busy through every round (PERF.md section 6, rows K8a/K8b).
constexpr int SPW = 2;                 // producer warpgroups
constexpr int SP = SPW * JP;           // producer threads: node j, m rows PM (p / JP) ..
constexpr int PM = BM / SPW;           // m rows of a producer thread
constexpr int SCW = 2;                 // consumer warpgroups
constexpr int SNT = SP + 128 * SCW;    // threads of the synthesis kernel
constexpr int STILES = BT / 64 / SCW;  // 64-ring tiles of a consumer warpgroup
constexpr int KSTEPS = JP / 8;         // k-steps of a product (wgmma k = 8 TF32)
constexpr int FRAG = 128 * 4;          // floats of one k-step's A fragments of a tile
constexpr int BAR_FULL = 1, BAR_EMPTY = 2, BAR_PROD = 3;  // named barriers
// Registers of a producer and a consumer thread (setmaxnreg). The launch
// gives every thread 65536 / SNT (ptxas allocates that much once the kernel
// holds setmaxnreg; chip_smoke.py checks it), and a consumer's increase
// waits for registers the producers released in the same block: the two
// must balance, or the consumers never start.
constexpr int PREGS = 112, CREGS = 144;
static_assert(SP * PREGS + (SNT - SP) * CREGS == 65536 && PREGS % 8 == 0 && CREGS % 8 == 0,
              "register file");
static_assert(PM * SPW == BM && PM == 2 && STILES * SCW * 64 == BT, "synthesis tiles");

// Shared memory of the synthesis kernel, in floats.
template <int C> struct SynthSmem {
  static constexpr int CP = 2;                   // columns per pass
  static constexpr int PASSES = C / CP;          // passes over the blocks of degrees
  static constexpr int NSC = NS * CP;            // (column, stream) pairs of a pass
  static constexpr int R = 2 * NSC + 4;          // row types of an m row: folds, chains' ends
  static constexpr int N = BM * R;               // columns of the product
  static constexpr int KSTR = 4 * N + 4;         // floats per quad of nodes of the fold buffer,
                                                 // padded: the producer's stores hit 32 banks
  static constexpr int WF = 0;                   // W [BT / 64][KSTEPS][128][4]
  static constexpr int FH = WF + BT * JP;        // folds hi [JP / 4][KSTR]: per quad of nodes,
  static constexpr int FL = FH + JP / 4 * KSTR;  //   per column its 4 nodes; folds lo
  static constexpr int KS = NSC <= 2 ? 28 : 16;  // degrees per slab of the tables (the longer
                                                 // slab where its registers allow)
  static constexpr int NZ = LBK / KS;            // slabs per block of degrees
  static constexpr int SLAB = 2 * KS * BM + KS * BM * NSC;  // a, b [KS][BM]; alm x stream
                                                            // [KS][BM][NSC]
  static constexpr int NV = (KS * BM * NSC + SP - 1) / SP;  // alm x stream entries a thread
                                                            // stages per slab, at most
  static constexpr int SL = FL + JP / 4 * KSTR;  // two slab buffers
  static constexpr int RAW = SL + 2 * SLAB;      // alm, stream [2][NV][SP] on their way in
  static constexpr int BAR = RAW + 2 * NV * SP;  // the mbarrier of W's copy
  static constexpr int SIZE = BAR + 2;
  static_assert(C % CP == 0 && N % 8 == 0 && N <= 256, "wgmma n");
  static_assert(LBK % KS == 0 && 2 * KS * BM <= SP, "slabs");
  static_assert(SIZE * 4 <= 232448, "shared memory");
  static_assert(FH % 4 == 0 && FL % 4 == 0 && SL % 4 == 0 && SLAB % 4 == 0 && BAR % 2 == 0,
                "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// bytes from global to shared memory by the TMA, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared memory written by threads, made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// (no memory clobbers: the operands in shared memory are fenced by the
// barriers around them, and loads of W may move across these)
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N));
}

// keeps the compiler from moving accesses of x across the asm around it
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// The descriptor of a K-major operand in shared memory without swizzle:
// 8 x 16-byte core matrices, kstride bytes apart along K and 128 bytes
// apart along N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t kstride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kstride >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d += a b: wgmma.m64nNk8, TF32 operands, float32 accumulators; a the A
// fragment in registers (lane 4 g + q of warp w: rows 16 w + g, + 8, of
// columns q, q + 4), b the descriptor of B [8 x N].
template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<80> {
  __device__ static __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna) by
// integer arithmetic, and hi, lo of x: cvt.rna.tf32.f32 spends five
// instructions on its checks for infinities and NaN, which W and the folds
// never hold
__device__ __forceinline__ uint32_t tf32_near(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_near(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_near(x);
  lo = tf32_near(x - __uint_as_float(hi));
}

// d = W^T B over the JP nodes for one 64-ring tile, in 3xTF32: wf the
// thread's float4 of k-step 0 in the tile's A fragments (k-step s at wf +
// s FRAG), fh and fl the fold buffer's hi and lo. A k-step's fragments are
// split in registers and stay there until its wgmmas are done: two k-steps
// in flight. (Four took more registers and were no faster on the card.)
template <int N>
__device__ __forceinline__ void syn_product(float (&d)[N / 2], const float* wf, uint32_t fh,
                                            uint32_t fl) {
  constexpr uint32_t KB = (4 * N + 4) * 4;  // bytes from a quad of nodes to the next
  constexpr int DEPTH = 2;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  fence_operands(d);
  uint32_t ah[DEPTH][4], al[DEPTH][4];
  float4 wn = *reinterpret_cast<const float4*>(wf);
#pragma unroll 1
  for (int s0 = 0; s0 < KSTEPS; s0 += DEPTH)
#pragma unroll
    for (int b = 0; b < DEPTH; ++b) {
      const int s = s0 + b;
      const float4 w = wn;
      if (s + 1 < KSTEPS) wn = *reinterpret_cast<const float4*>(wf + (s + 1) * FRAG);
      if (s0 > 0) wgmma_wait<DEPTH - 1>();  // k-step s - DEPTH is done with these registers
      split_near(w.x, ah[b][0], al[b][0]);
      split_near(w.y, ah[b][1], al[b][1]);
      split_near(w.z, ah[b][2], al[b][2]);
      split_near(w.w, ah[b][3], al[b][3]);
      const uint64_t dh = smem_desc(fh + 2 * s * KB, KB), dl = smem_desc(fl + 2 * s * KB, KB);
      wgmma_fence();
      Wgmma<N>::mma(d, al[b], dh);
      Wgmma<N>::mma(d, ah[b], dl);
      Wgmma<N>::mma(d, ah[b], dh);
      wgmma_commit();
    }
  wgmma_wait<0>();
  fence_operands(d);
}

// 4 bytes from global to shared memory, not through registers; zeros
// where ok is false (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// The producer: thread p, node j = p % JP and m rows PM (p / JP) .. + PM -
// 1, builds every round's folds and hands them over (see
// blk_synthesis_kernel). Its tables come in slabs of KS degrees,
// double-buffered: each thread starts the copies of its share of the next
// slab (cp.async) before it steps through this one, and weighs the alm by
// the streams after.
template <int C>
__device__ __forceinline__ void syn_build(float* smem, const float* __restrict__ A,
                                          const float* __restrict__ ab,
                                          const float* __restrict__ cs, float ctj, int p,
                                          int first, int nlb, int m0, int nl, int nm) {
  using S = SynthSmem<C>;
  constexpr int NSC = S::NSC, KS = S::KS, NZ = S::NZ, NV = S::NV;
  const int j = p % JP, mi0 = PM * (p / JP);
  const size_t nlm = (size_t)nl * nm;
  const int nz = S::PASSES * (nlb - first) * NZ;  // slabs in all
  float* raw = smem + S::RAW + p;  // this thread's alm [NV] and streams [NV], SP apart
  // The slabs in order: the passes over the columns from c0 = CP pass, each
  // over the blocks from first, each in NZ slabs of KS degrees from l0.
  // fetch(z) starts the copies of slab z, the next one in that order: a
  // and b straight to the slab buffer, the alm and streams to raw.
  int l0 = first * LBK, c0 = 0;
  auto fetch = [&](int z) {
    if (p < 2 * KS * BM) {
      const int e = p % (KS * BM), l = l0 + e / BM, m = m0 + e % BM;
      const bool ok = l < nl && m < nm;
      cp_async4(smem + S::SL + (z & 1) * S::SLAB + p,
                ok ? ab + (p < KS * BM ? 0 : nlm) + (size_t)l * nm + m : ab, ok);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = p + SP * v, u = i % NSC, km = i / NSC;
      if (i >= KS * BM * NSC) break;
      const int l = l0 + km / BM, m = m0 + km % BM;
      const bool ok = l < nl && m < nm;
      const size_t lm = (size_t)l * nm + m;
      cp_async4(raw + SP * v, ok ? A + lm * C + c0 + u / NS : A, ok);
      if constexpr (MODE != SCALAR) cp_async4(raw + SP * (NV + v), ok ? cs + (u % NS) * nlm + lm : cs, ok);
    }
    l0 += KS;
    if (l0 >= nlb * LBK) {
      l0 = first * LBK;
      c0 += S::CP;
    }
  };
  // the copies are in (this thread's own: no barrier); weigh the alm
  auto put = [&](int buf) {
    cp_async_wait_all();
    float* t = smem + S::SL + buf * S::SLAB + 2 * KS * BM + p;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (p + SP * v >= KS * BM * NSC) break;
      t[SP * v] = MODE == SCALAR ? raw[SP * v] : raw[SP * v] * raw[SP * (NV + v)];
    }
  };
  fetch(0);
  put(0);
  named_sync(BAR_PROD, SP);
  float gAc[PM], gAp[PM], gBc[PM], gBp[PM], fA[PM][NSC], fB[PM][NSC];
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      gAc[i] = gBp[i] = 1.0f;
      gAp[i] = gBc[i] = 0.0f;
#pragma unroll
      for (int u = 0; u < NSC; ++u) fA[i][u] = fB[i][u] = 0.0f;
    }
  };
  reset();
  float* fh = smem + S::FH + (j >> 2) * S::KSTR + (j & 3);
  float* fl = smem + S::FL + (j >> 2) * S::KSTR + (j & 3);
  for (int z = 0; z < nz; ++z) {
    if (z + 1 < nz) fetch(z + 1);  // in flight while this slab is stepped
    const float* t = smem + S::SL + (z & 1) * S::SLAB;
    const float* tas = t + 2 * KS * BM + mi0 * NSC;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float2 a2 = *reinterpret_cast<const float2*>(t + k * BM + mi0);
      const float2 b2 = *reinterpret_cast<const float2*>(t + KS * BM + k * BM + mi0);
      const float av[PM] = {a2.x, a2.y}, bv[PM] = {b2.x, b2.y};
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        chain_step(gAc[i], gAp[i], gBc[i], gBp[i], av[i], bv[i], ctj);
        const float* as = tas + (k * BM + i) * NSC;
#pragma unroll
        for (int u = 0; u < NSC; u += 2) {
          const float2 v = *reinterpret_cast<const float2*>(as + u);
          const bool p0 = fam_prev(u % NS), p1 = fam_prev((u + 1) % NS);
          fA[i][u] = fmaf(v.x, p0 ? gAp[i] : gAc[i], fA[i][u]);
          fB[i][u] = fmaf(v.x, p0 ? gBp[i] : gBc[i], fB[i][u]);
          fA[i][u + 1] = fmaf(v.y, p1 ? gAp[i] : gAc[i], fA[i][u + 1]);
          fB[i][u + 1] = fmaf(v.y, p1 ? gBp[i] : gBc[i], fB[i][u + 1]);
        }
      }
    }
    if (z + 1 < nz) put((z + 1) & 1);
    named_sync(BAR_PROD, SP);  // the next slab is in; this one is read
    if (z % NZ != NZ - 1) continue;
    // the round is built: hand it over. Row type r of m row mi: column c's
    // NS curr-family folds (chain A), its NS prev-family folds (chain B),
    // then the ends gA_c, gA_p, gB_c, gB_p
    if (z >= NZ) named_sync(BAR_EMPTY, SNT);  // the consumers have read the round before
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int r = 0; r < S::R; ++r) {
        const int c = r / (2 * NS), w = r % (2 * NS), e = r - 2 * NSC;
        const float v = r < 2 * NSC ? (w < NS ? fA[i][c * NS + w] : fB[i][c * NS + w - NS])
                                    : (e == 0 ? gAc[i] : e == 1 ? gAp[i] : e == 2 ? gBc[i] : gBp[i]);
        const int n = 8 * (r >> 1) + 2 * (mi0 + i) + (r & 1);
        uint32_t vh, vl;
        split_near(v, vh, vl);
        fh[4 * n] = __uint_as_float(vh);
        fl[4 * n] = __uint_as_float(vl);
      }
    fence_async_shared();
    named_arrive(BAR_FULL, SNT);
    reset();
  }
}

// The ring factors combine reads, loaded where they are used: held across
// the block loop they would take registers the accumulators need.
__device__ __forceinline__ float ld_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ RingRow ring_now(const float* __restrict__ cth,
                                            const float* __restrict__ rows, int t, int nt) {
  RingRow r{0.0f, 0.0f, 0.0f, 0.0f};
  if (t < nt) {
    if constexpr (MODE == DERIV || MODE == SPIN1) {
      r.cts = ld_now(rows + t);
      r.ist = ld_now(rows + nt + t);
    } else if constexpr (MODE == SPIN2) {
      r.ct = ld_now(cth + t);
      r.ist2 = ld_now(rows + 2 * nt + t);
    }
  }
  return r;
}

// A consumer thread: ct in 0..255 over the two consumer warpgroups (see
// blk_synthesis_kernel). Its entries (i, e): m row q, ring 64 (STILES cw +
// i) + 16 wq + g + 8 e of the tile. A pass over the blocks takes CP columns
// from the state at the first block.
template <int C>
__device__ __forceinline__ void syn_consume(float* smem, const float* __restrict__ state,
                                            const float* __restrict__ cth,
                                            const float* __restrict__ rows,
                                            float* __restrict__ out, uint32_t wbar, int ct,
                                            int first, int nlb, int m0, int t0, int nm, int nt) {
  using S = SynthSmem<C>;
  constexpr int N = S::N, NSC = S::NSC, CP = S::CP;
  const int cw = ct >> 7, wq = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, q = lane & 3;
  const int m = m0 + q;
  const size_t plane = (size_t)nm * nt;
  const float* wf = smem + S::WF + STILES * cw * KSTEPS * FRAG + (wq * 32 + lane) * 4;
  const uint32_t fh = smem_u32(smem + S::FH), fl = smem_u32(smem + S::FL);
  const int rounds = S::PASSES * (nlb - first);
  mbar_wait(wbar, 0);  // W is in
  int round = 0;
  for (int p = 0; p < S::PASSES; ++p) {
    float prev[STILES][2], curr[STILES][2], acc[STILES][2][NFUN][CP];
    int lev[STILES][2];
#pragma unroll
    for (int i = 0; i < STILES; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + 64 * (STILES * cw + i) + 16 * wq + g + 8 * e;
        const bool valid = m < nm && t < nt;
        const size_t mt = (size_t)m * nt + t;
        prev[i][e] = valid ? state[mt] : 0.0f;
        curr[i][e] = valid ? state[plane + mt] : 0.0f;
        lev[i][e] = valid ? (int)state[2 * plane + mt] : 0;
#pragma unroll
        for (int f = 0; f < NFUN; ++f)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) acc[i][e][f][cc] = 0.0f;
      }
    for (int il = first; il < nlb; ++il, ++round) {
      named_sync(BAR_FULL, SNT);  // the round's folds are in
#pragma unroll
      for (int i = 0; i < STILES; ++i) {
        float d[N / 2];
        syn_product<N>(d, wf + i * KSTEPS * FRAG, fh, fl);
        if (i == STILES - 1 && round + 1 < rounds) named_arrive(BAR_EMPTY, SNT);
        // row type r of entry e: accumulator 4 (r / 2) + 2 e + (r & 1)
#define PT_D(r, e) d[4 * ((r) >> 1) + 2 * (e) + ((r)&1)]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const RingRow ring =
              ring_now(cth, rows, t0 + 64 * (STILES * cw + i) + 16 * wq + g + 8 * e, nt);
          const float fac = level_factor(lev[i][e]);
          const float cf = curr[i][e] * fac, pf = prev[i][e] * fac;
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) {
            float ts[NS], u[NFUN];
#pragma unroll
            for (int s = 0; s < NS; ++s)
              ts[s] = PT_D(cc * 2 * NS + s, e) * cf + PT_D(cc * 2 * NS + NS + s, e) * pf;
            combine<MODE>(u, ts, ring, float(m));
#pragma unroll
            for (int f = 0; f < NFUN; ++f) acc[i][e][f][cc] += u[f];
          }
          // the state step over the block, renormalized
          constexpr int r0 = 2 * NSC;
          float nc = PT_D(r0, e) * curr[i][e] + PT_D(r0 + 2, e) * prev[i][e];
          float np = PT_D(r0 + 1, e) * curr[i][e] + PT_D(r0 + 3, e) * prev[i][e];
          if (fabsf(nc) > band()) {
            np *= invband();
            nc *= invband();
            lev[i][e] += 1;
          }
          prev[i][e] = np;
          curr[i][e] = nc;
        }
#undef PT_D
      }
    }
#pragma unroll
    for (int i = 0; i < STILES; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + 64 * (STILES * cw + i) + 16 * wq + g + 8 * e;
        if (m >= nm || t >= nt) continue;
#pragma unroll
        for (int f = 0; f < NFUN; ++f)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            out[((size_t)f * C + p * CP + cc) * plane + (size_t)m * nt + t] = acc[i][e][f][cc];
      }
  }
}

template <int C>
__global__ void __launch_bounds__(SNT, 1)
blk_synthesis_kernel(const float* __restrict__ A, const float* __restrict__ ab,
                     const float* __restrict__ cs, const float* __restrict__ state,
                     const int* __restrict__ start, const float* __restrict__ ctv,
                     const float* __restrict__ Wf, const float* __restrict__ cth,
                     const float* __restrict__ rows, float* __restrict__ out, int nl, int nm,
                     int nt) {
  using S = SynthSmem<C>;
  extern __shared__ __align__(16) float syn_smem[];
  const int tb = blockIdx.x, mb = blockIdx.y;
  const int nlb = (nl + LBK - 1) / LBK;
  const int first = start[(size_t)mb * gridDim.x + tb];
  if (first >= nlb) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int m0 = mb * BM, t0 = tb * BT;
  const uint32_t wbar = smem_u32(syn_smem + S::BAR);
  if (tid == 0) mbar_init(wbar, 1);
  __syncthreads();
  if (tid == 0) {  // W of the ring tile, by the TMA, once
    constexpr uint32_t BYTES = BT * JP * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wbar),
                 "r"(BYTES)
                 : "memory");
    constexpr uint32_t PART = BYTES / 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bulk_load(smem_u32(syn_smem + S::WF) + k * PART,
                reinterpret_cast<const char*>(Wf + (size_t)tb * BT * JP) + k * PART, PART, wbar);
  }
  // registers: the launch gives each thread 128; the producers hand 16 of
  // theirs to the consumers, whose accumulators, A fragments and entries
  // would spill at 128 (spin2 at C = 4)
  if (tid < SP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS) : "memory");
    syn_build<C>(syn_smem, A, ab, cs, ctv[(size_t)tb * JP + tid % JP], tid, first, nlb, m0, nl, nm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS) : "memory");
    syn_consume<C>(syn_smem, state, cth, rows, out, wbar, tid - SP, first, nlb, m0, t0, nm, nt);
  }
}

template <int C>
int launch_blk_synthesis(const float* A, const float* ab, const float* cs, const float* state,
                         const int* start, const float* ctv, const float* Wf, const float* cth,
                         const float* rows, float* out, int nl, int nm, int nt,
                         cudaStream_t st) {
  const size_t bytes = SynthSmem<C>::SIZE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blk_synthesis_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nt + BT - 1) / BT, (nm + BM - 1) / BM);
  blk_synthesis_kernel<C><<<grid, SNT, bytes, st>>>(A, ab, cs, state, start, ctv, Wf, cth, rows,
                                                    out, nl, nm, nt);
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
                                          const void* ctv, const void* Wf, const void* cth,
                                          const void* rows, void* out, int nl, int nm, int nt,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || nm <= 0 || nt <= 0) return 0;
  const int* s0 = static_cast<const int*>(start);
  float* o = static_cast<float*>(out);
  switch (C) {
    case 2:
      return launch_blk_synthesis<2>(FP(A), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(Wf),
                                     FP(cth), FP(rows), o, nl, nm, nt, st);
    case 4:
      return launch_blk_synthesis<4>(FP(A), FP(ab), FP(cs), FP(state), s0, FP(ctv), FP(Wf),
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

// The synthesis kernel's dynamic shared memory in bytes at C columns (2 or
// 4), or -1.
extern "C" int PT_ENTRY(pt_blk_synthesis_smem)(int C) {
  return C == 2 ? (int)(SynthSmem<2>::SIZE * sizeof(float))
                : (C == 4 ? (int)(SynthSmem<4>::SIZE * sizeof(float)) : -1);
}

// Tile sizes, so the host can size the tables and the partial planes.
extern "C" int PT_ENTRY(pt_blk_tile_theta)() { return BT; }
extern "C" int PT_ENTRY(pt_blk_tile_m)() { return BM; }
extern "C" int PT_ENTRY(pt_blk_degrees)() { return LBK; }
extern "C" int PT_ENTRY(pt_blk_nodes)() { return JP; }
