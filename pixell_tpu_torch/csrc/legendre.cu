// Hand-written Hopper (sm_90a) kernels for the Legendre stage of the
// spherical harmonic transform. Five kernels, one recurrence:
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
// Every launch of K1-K4, float32 or float64, runs one of two kernels
// redesigned for this card, each templated on the element type:
//
//   bulk_analysis    K2's and K4's (design before bulk_analysis_kernel)
//   bulk_synthesis   K1's and K3's (design before bulk_synthesis_kernel)
//
// with entry points pt_<form>_bulk_<kernel>_<mode> (float) and
// pt_<form>_bulk_<kernel>_f64_<mode> (double). Two float64 near-pole passes,
// also redesigned for this card, take the near-pole rings of every float32
// transform, which the TPU ran in double-single arithmetic through K3/K4:
//
//   polar_analysis   K4's (design below, before polar_analysis_kernel)
//   polar_synthesis  K3's (design before polar_synthesis_kernel)
//
// each in the four Legendre modes of the reference (K6, _make_funcs
// sht_pallas.py:408): scalar emits lambda_lm; deriv [lambda, d lambda/d theta];
// spin1 [w1, x1]; spin2 [w2, x2], the theta-functions of the spin-weighted
// harmonics, evaluated per (l, m, theta) in registers from lambda_l and
// lambda_{l-1} (formulas in pixell_tpu_torch/ops/sht_core.py ModeFuncs).
// The mode is a compile-time constant; this file is compiled once per mode
// (-DLEGENDRE_MODE=0..4, in parallel), and each object exports the entry
// points pt_<kernel>_<mode>.
//
// K7, the fifth mode, wigner (any spin s; K3 and K4 only, as the reference
// has no half-sky form of it), replaces mode="wigner" of the full kernels,
// driven by wigner_synthesis_scan_pallas (sht_pallas.py:2165) and
// wigner_analysis_scan_pallas (:2221). The spin-weighted theta-functions are
//   w = (lam_p + (-1)^s lam_m)/2,  x = (lam_p - (-1)^s lam_m)/2
// with lam_p = (-1)^m sqrt((2l+1)/4pi) d^l_{-m,s}(theta) and lam_m its
// s -> -s partner, both from the recurrence
//   lam_l = a_lm ((cos theta +- c_lm) lam_{l-1} - b_lm lam_{l-2}),
// seeded at l = max(m, s). The TPU ran one branch per pass and combined the
// two results afterwards; here one thread carries BOTH branches' states,
// reads the one staged (a, b, c) row with +c and -c, forms w and x in
// registers and accumulates them as the spin-2 mode does: half the launches,
// one read of the alm, and no combine pass over the ring data. It is bound
// like the other modes, by arithmetic: ~23 operations per (l, m, theta)
// triple for the two steps and the combination, before the accumulation.
//
// Stop degrees (the reference's lstop): K3/K4 and the float32 K1 take a
// table [m blocks, ring tiles] of the degree before which each block's
// l-loop ends (K1's from its northern rings); a null table runs every block
// to the end. 0 marks a dead block (_dead_table
// sht_pallas.py:677), one beyond the horizon of its rings,
// m_lo - s > lmax max(sin theta) + slack, where every value is below ~1e-12:
// a dead synthesis block writes zeros and runs no l-loop, analysis skips a
// dead ring tile in its plane loop. The exit is uniform over the block, so
// the barriers stay safe.
// State handoff (the reference's dump_state, sht_pallas.py:1546-1549,
// :1619-1625, :2040-2046; Legendre modes): with a state buffer [3, nm, nt], each
// thread writes its scaled recurrence state (prev, curr, level as a number)
// as it leaves its loop. The block-Legendre kernels (blockleg.cu) resume from
// it; their stop degrees are multiples of 8, so the state is handed over
// just renormalized.
//
// The state scale is S = 60 in float32 and S = 850 in float64. Where the TPU
// ran double-single arithmetic, Hopper has native f64 (and nvcc's default
// FMA contraction would silently break Dekker double-single sums anyway).
// Float64 launches take no stop degrees and hand no state over: the terms a
// dead tile skips lie above what a float64 transform promises.
//
// Maths (the plain PyTorch twin is pixell_tpu_torch/ops/sht_core.py):
// the normalized associated Legendre values lambda_lm(theta) obey
//   lambda_l = a_lm ((cos theta) lambda_{l-1} - b_lm lambda_{l-2}),
// seeded with lambda_mm at l = m. The state is held scaled,
// lambda = val * 2^(S*level), and renormalized every 8 l-steps, so
// lambda_mm ~ sin^m(theta) cannot underflow near the poles; only levels 0
// and -1 contribute above 2^-S. cos(theta) comes in two parts (hi + lo)
// for float: a plain f32 cos has ~3e-8 absolute error near the poles, which
// the recurrence amplifies by ~l^2 (float64 has no low part). The coefficients a, b, the mode
// functions' e_lm = sqrt((l-m)(l+m)(2l+1)/(2l-1)) and the per-degree norms
// are TABLES computed outside with correctly rounded sqrt and divide
// (ops/sht_cuda.py coef_tables, l_tables) and staged in shared memory beside
// a and b; the kernels do no sqrt or divide. The per-ring rows cos/sin,
// 1/sin, 1/sin^2 and the pole flag come from float64 host maths. Build
// WITHOUT --use_fast_math: approximate sqrt/divide are what broke the TPU
// recurrence.
//
// What bounds these kernels on an H100: FP32 (or FP64) arithmetic per
// (l, m, theta) triple over a triangle of ~lmax^2/2 (l, m) pairs per ring:
// ~7 operations for the recurrence step, 0 (scalar), ~8 (deriv), ~14
// (spin1) or ~24 (spin2) for the mode functions, and 2 per function and
// coefficient column for the accumulation, plus one reduction add per
// column in analysis (chip_smoke.py kernel_ops counts them). Device-memory
// traffic is O(lmax^2 + nfun C nm nt) (the tables, the alm, the seeds, the
// output), far below it.
// Design of K1-K4: a thread keeps the recurrence states of its rings of one
// m row, their ring rows and its accumulators in registers for the whole
// l-loop, which starts at the block's smallest m, so the zero triangle
// l < m is skipped for free. A block covers MY m rows; per chunk of BLC
// degrees it stages a_lm, b_lm, e_lm, the degree norms (and for synthesis
// the alm A[l, m, :]) in shared memory, since they are the same for every
// ring of an m row. All C coefficient columns of a block (C = 4 for a
// spin-2 block: E and B, real and imaginary) share one recurrence pass.
// Warps never straddle two m rows, so the seed branch at l = m is
// warp-uniform.
//
// Half-sky kernels: u_f(pi - theta) = PSIGN[f] (-1)^(l+m) u_f(theta)
// (sht_pallas.py:61); PSIGN is (1) scalar, (1, -1) deriv, (-1, 1) spin1,
// (1, -1) spin2. K1's mirror ring takes that sign; K2 reads the even plane
// (north + south) where it is +1 and the odd plane where it is -1.
//
// Analysis writes one partial per (l, m, c) and block into its own plane of
// a zero-initialized [planes, nl, nm, C] buffer, looping over the ring tiles
// that belong to that plane; the planes are summed afterwards in a
// deterministic second pass. No atomics: results are reproducible.
//
// Every extern "C" entry point launches on the given stream, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

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
#elif LEGENDRE_MODE == 4
#define MODE_TAG wigner
#else
#error "LEGENDRE_MODE must be 0 (scalar), 1 (deriv), 2 (spin1), 3 (spin2) or 4 (wigner)"
#endif
#define PT_PASTE2(a, b) a##_##b
#define PT_PASTE(a, b) PT_PASTE2(a, b)
#define PT_ENTRY(name) PT_PASTE(name, MODE_TAG)

namespace {

constexpr int SCALAR = 0, DERIV = 1, SPIN1 = 2, SPIN2 = 3, WIGNER = 4;
constexpr int MODE = LEGENDRE_MODE;
constexpr int NFUN = MODE == SCALAR ? 1 : 2;
constexpr int NBR = MODE == WIGNER ? 2 : 1;  // recurrence branches per thread

// parity of mode function f under theta -> pi - theta
__host__ __device__ constexpr int psign(int f) {
  return MODE == SCALAR ? 1 : (MODE == SPIN1 ? (f == 0 ? -1 : 1) : (f == 0 ? 1 : -1));
}

constexpr int TX = 64;  // rings of a block's tile: the stop table's (TILE_T)
constexpr int MY = 4;   // m rows of a block's tile (TILE_M)

// float32 runs its recurrence on cos theta in two parts (hi + lo); float64
// has no low part
template <typename T> constexpr bool HAS_LO = std::is_same_v<T, float>;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

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

// The per-ring rows of one thread's ring: cos, cos/sin, 1/sin, 1/sin^2,
// the not-a-pole flag and the north/south pole flags.
template <typename T> struct Ring {
  T ct, ct_st, inv_st, inv_st2, notpole, pn, ps;
};

template <typename T>
__device__ __forceinline__ Ring<T> load_ring(const T* __restrict__ cth,
                                             const T* __restrict__ rows, int t,
                                             int nt, bool valid) {
  Ring<T> r{T(0), T(0), T(0), T(0), T(1), T(0), T(0)};
  if (!valid) return r;
  r.ct = cth[t];
  if constexpr (MODE != SCALAR) {
    r.ct_st = rows[t];
    r.inv_st = rows[nt + t];
    r.inv_st2 = rows[2 * nt + t];
    r.notpole = rows[3 * nt + t];
    const T pole = T(1) - r.notpole;
    r.pn = r.ct > T(0) ? pole : T(0);
    r.ps = r.ct < T(0) ? pole : T(0);
  }
  return r;
}

// Mode functions u[NFUN] at (l, m) on ring r from the true lambda_l (lam)
// and lambda_{l-1} (lam1); e = e_lm, nrm and hp the degree's norm and half
// pole factor (pixell_tpu/ops/sht_pallas.py _make_funcs :408-451). The 1/sin
// terms vanish on pole rings (notpole = 0, inv_st = 0), where the limits at
// m = 1 (deriv, spin1) or m = 2 (spin2) take their place. With SEL the
// conditions are selects instead of branches (the pole term then adds a
// zero where it does not apply; the values are the same), so that a caller
// that evaluates several degrees can interleave them: the near-pole
// kernels' consumers. K1-K4 keep the branches, which are faster there.
template <bool SEL = false, typename T>
__device__ __forceinline__ void mode_funcs(T (&u)[NFUN], T lam, T lam1, int l,
                                           int m, T e, T nrm, T hp,
                                           const Ring<T>& r) {
  if constexpr (MODE == SCALAR) {
    u[0] = lam;
    return;
  }
  const T lf = T(l);
  const T sgl = (l & 1) ? T(-1) : T(1);
  constexpr int MP = MODE == SPIN2 ? 2 : 1;  // the m of the pole limits
  const bool high = l >= MP, pole = m == MP && high;
  const T hps = SEL && !pole ? T(0) : hp;    // the pole term's factor
  if constexpr (MODE == DERIV) {
    T d = (lf * r.ct_st * lam - e * r.inv_st * lam1) * r.notpole;
    if (SEL || pole) d += -nrm * hps * (r.pn + sgl * r.ps);
    u[0] = lam;
    u[NFUN - 1] = d;
    return;
  }
  T w = T(0), x = T(0);
  if (SEL || high) {
    if constexpr (MODE == SPIN1) {
      w = -nrm * (lf * r.ct_st * lam - e * r.inv_st * lam1) * r.notpole;
      x = nrm * T(m) * r.inv_st * lam * r.notpole;
    } else {
      const T lmm = T(l - m * m);  // exact in integers, rounded once
      w = nrm * (-(T(2) * lmm * r.inv_st2 + lf * (lf - T(1))) * lam +
                 T(2) * e * r.ct * r.inv_st2 * lam1) * r.notpole;
      x = T(2) * nrm * T(m) * r.inv_st2 * (-(lf - T(1)) * r.ct * lam + e * lam1) *
          r.notpole;
    }
    if (SEL || m == MP) {
      w += hps * (r.pn + sgl * r.ps);
      x += hps * (-r.pn + sgl * r.ps);
    }
  }
  u[0] = SEL && !high ? T(0) : w;
  u[NFUN - 1] = SEL && !high ? T(0) : x;
}

// One thread's recurrence: the state and seed of each branch.
template <typename T> struct Recur {
  State<T> s[NBR];
  T seedv[NBR];
  int seedl[NBR];
  int lseed;
};

// sv, sl [NBR, nm, nt]: the seeds of entry mt = m nt + t, zero where invalid.
template <typename T>
__device__ __forceinline__ Recur<T> load_recur(const T* __restrict__ sv,
                                               const int* __restrict__ sl,
                                               size_t mt, size_t plane, int m,
                                               int spin, bool valid) {
  Recur<T> rc;
#pragma unroll
  for (int br = 0; br < NBR; ++br) {
    rc.s[br] = State<T>{T(0), T(0), 0};
    rc.seedv[br] = valid ? sv[br * plane + mt] : T(0);
    rc.seedl[br] = valid ? sl[br * plane + mt] : 0;
  }
  rc.lseed = MODE == WIGNER ? max(m, spin) : m;
  return rc;
}

template <typename T>
__device__ __forceinline__ void rescale(Recur<T>& rc) {
#pragma unroll
  for (int br = 0; br < NBR; ++br) rescale(rc.s[br]);
}

// The degree before which block (mb, tb) of ntb ring tiles ends its l-loop:
// its entry of the stop table, at most nl; nl without a table.
__device__ __forceinline__ int stop_degree(const int* __restrict__ lstop, int mb,
                                           int tb, int ntb, int nl) {
  return lstop == nullptr ? nl : min(nl, lstop[(size_t)mb * ntb + tb]);
}

// Hand the recurrence state of entry mt over: state [3, nm, nt] holds prev,
// curr and the level. The wigner mode has two states and hands over none.
template <typename T>
__device__ __forceinline__ void dump_state(T* __restrict__ state, size_t mt,
                                           size_t plane, const State<T>& s) {
  state[mt] = s.prev;
  state[plane + mt] = s.curr;
  state[2 * plane + mt] = T(s.lev);
}

// K2 / K4, redesigned for Hopper (bulk_analysis_kernel), in float32 and in
// float64: every launch of K2 and K4 takes it. It replaced analysis_kernel,
// one ring a thread, which reduced u_f F over a warp's rings at every degree
// and column: 5 shuffle rounds (a quarter of the FP32 rate; in float64 each
// round two 32-bit shuffles) and a shared-memory write, ~50 FMA slots per
// (l, m, theta) triple in scalar mode and ~100 in spin2, where the
// recurrence takes 7, and a barrier and a second pass over the row's warps
// per 32 degrees. Here:
//   - a thread carries R rings of one m row (R = 2: a warp is one m row of
//     a 64-ring tile; R = 4, the full float32 scalar form: a half-warp is;
//     R = 1, the float64 deriv mode at C = 4 (f64_analysis_rings): a warp
//     is one m row of a 32-ring tile), R independent recurrences whose
//     products it sums itself;
//   - it keeps the sums of a group of BG = 8 degrees, the renormalization
//     period, in registers, and the row's lanes meet once per group in a
//     reduce-scatter butterfly: each round halves the values a lane holds
//     (8 C values: 4 C + 2 C + ... shuffles), so that each lane is left with
//     whole sums of its own (degree, column) entries, which it adds into the
//     partial plane itself: ~1 shuffle per degree and column where
//     analysis_kernel took 5, and no shared-memory staging of the sums and
//     no second barrier per chunk;
//   - a block is one tile of the stop table (MY m rows x TX rings; at R = 1,
//     without a stop table, MY x 32), so the stop degree stays uniform over
//     it; the coefficients of a chunk of BLC degrees are staged in
//     shared memory, double-buffered, each thread loading its share of the
//     next chunk into registers before the current chunk's work, with one
//     barrier per chunk;
//   - degree groups start at multiples of 8 below the block's first seed,
//     so a group never straddles a renormalization or a handoff stop (both
//     multiples of 8); a group cut by the stop runs its degrees under a
//     uniform test, so each ring's loop and dumped state end at the stop;
//   - on the half-sky form the even/odd planes are swapped once per tile on
//     odd m rows, so a degree's plane follows from its place in the group
//     at compile time;
//   - the seed test and the level's scale factor leave the steps: all
//     seeds of a block fall in its first group, and the factor changes only
//     there and at a renormalization, the group's last step;
//   - STOPS and DUMP are template parameters: launches without a stop table
//     or a state handoff carry neither in registers; float64 launches take
//     neither.
// The partial planes stay: one block per stop tile gives ~nm nt / 256
// blocks, where a block owning every ring tile of its m rows would give
// nm / MY (188 at lmax 750), too few warps to hide the recurrence's latency.
constexpr int BLC = 32;  // degrees staged per chunk
constexpr int BG = 8;    // degrees reduced together: the renormalization period
// Rings per thread, float32: analysis four in the full scalar form (four
// rings halve the butterfly per triple; measured faster on the lmax-2000
// chunks of K4, many waves of blocks deep), else two (measured faster in
// every other form and mode at the main path's shapes); synthesis two in
// scalar mode, else one. Float64, by mode and coefficient count C: the
// rings a thread and the blocks an SM that its kernels' launch bounds ask
// for, which caps their registers at 65536 / (threads x blocks) (1: no
// cap; the float32 kernels' bounds give the threads alone), chosen among
// the settings that do not spill: analysis two rings (one in deriv at
// C = 4, which spills 16 bytes at two), three blocks in deriv at C = 2 (two in
// the half-sky form, which spills 64 bytes at three with the m block's offset);
// synthesis two rings in scalar mode and in spin1 at C = 4 (which spills
// at the cap below), else one ring at two blocks, 128 registers. Measured by
// chip_smoke.py --phases variants, which builds the alternatives
// (BULK_VARIANTS edits these lines); the numbers are in PERF.md section 6.
__host__ __device__ constexpr int f32_analysis_rings(bool SYM) { return MODE == SCALAR && !SYM ? 4 : 2; }
__host__ __device__ constexpr int f32_synthesis_rings() { return MODE == SCALAR ? 2 : 1; }
__host__ __device__ constexpr int f64_analysis_rings(int C) { return MODE == DERIV && C == 4 ? 1 : 2; }
__host__ __device__ constexpr int f64_analysis_blocks(int C, bool SYM) { return MODE == DERIV && C == 2 ? (SYM ? 2 : 3) : 1; }
__host__ __device__ constexpr int f64_synthesis_rings(int C) { return MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 2 : 1; }
__host__ __device__ constexpr int f64_synthesis_blocks(int C) { return MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 1 : 2; }
template <typename T, int C, bool SYM> constexpr int bulk_rings() {
  return HAS_LO<T> ? f32_analysis_rings(SYM) : f64_analysis_rings(C);
}
// The lanes of an m row at R rings a thread in bulk_analysis_kernel: a
// warp, or at R = 4 a half-warp; a block's tile is MY rows x (lanes R)
// rings.
__host__ __device__ constexpr int anal_lanes(int R) { return R == 1 ? 32 : TX / R; }

// The factor that unscales a state at level lev: only levels 0 and -1
// contribute above 2^-S.
template <typename T>
__device__ __forceinline__ T level_factor(int lev) {
  return lev == 0 ? T(1) : (lev == -1 ? Scale<T>::invband() : T(0));
}

// The end of the degree groups (from l8, the block's first) that hold a
// seed of the block's MY rows from m = mb (their seeds at max(m, spin) in
// wigner mode, else at m): l8 + BG, one group, where mb is a multiple of MY
// (the whole transform's blocks), and up to two groups for an m block that
// starts elsewhere.
__device__ __forceinline__ int seed_groups_end(int l8, int mb, int spin) {
  const int last = MODE == WIGNER ? max(mb + MY - 1, spin) : mb + MY - 1;
  return max(l8 + BG, (last + BG) & ~(BG - 1));
}

// One recurrence step at degree l for a row seeded at degree lseed (m; in
// wigner mode max(m, s)). Returns the true lambda_l and sets lam1 to the true
// lambda_{l-1} (zero at the seed). cadd is the wigner mode's offset on
// cos(theta), +c or -c by branch; xlo the low part of cos theta (float).
// The level's factor fac is kept by the caller, since it changes only at
// the seed and at a renormalization; without SEED the step has no seed test
// (the degrees past every seed of the block).
template <bool SEED, typename T>
__device__ __forceinline__ T bulk_step(State<T>& s, T& fac, int l, int lseed, T a, T b, T x,
                                       T xlo, T cadd, T seedv, int seedl, T& lam1) {
  T t;
  if constexpr (HAS_LO<T>) t = x * s.curr + xlo * s.curr;
  else t = x * s.curr;
  if constexpr (MODE == WIGNER) t += cadd * s.curr;
  T nw = a * (t - b * s.prev);
  T cz = s.curr;
  if (SEED && l == lseed) {  // seed; the stale previous value has another scale
    nw = seedv;
    s.lev = seedl;
    cz = T(0);
    fac = level_factor<T>(seedl);
  }
  s.prev = cz;
  s.curr = nw;
  lam1 = cz * fac;
  return nw * fac;
}

// Advance the recurrence to degree l and evaluate the mode functions u[NFUN]
// there, with each branch's level factor fac[br]. a, b, e are the staged
// coefficients of (l, m): e is e_lm, or c_lm in wigner mode, where sgs =
// (-1)^s.
template <bool SEED, typename T>
__device__ __forceinline__ void bulk_advance(T (&u)[NFUN], Recur<T>& rc, T (&fac)[NBR], int l,
                                             int m, T a, T b, T e, T nrm, T hp, const Ring<T>& r,
                                             T xlo, T sgs) {
  T lam1;
  if constexpr (MODE == WIGNER) {
    const T lp = bulk_step<SEED>(rc.s[0], fac[0], l, rc.lseed, a, b, r.ct, xlo, e, rc.seedv[0],
                                 rc.seedl[0], lam1);
    const T lm = sgs * bulk_step<SEED>(rc.s[NBR - 1], fac[NBR - 1], l, rc.lseed, a, b, r.ct, xlo,
                                       -e, rc.seedv[NBR - 1], rc.seedl[NBR - 1], lam1);
    u[0] = T(0.5) * (lp + lm);
    u[NFUN - 1] = T(0.5) * (lp - lm);
  } else {
    const T lam = bulk_step<SEED>(rc.s[0], fac[0], l, rc.lseed, a, b, r.ct, xlo, T(0),
                                  rc.seedv[0], rc.seedl[0], lam1);
    mode_funcs(u, lam, lam1, l, m, e, nrm, hp, r);
  }
}

// The low part of cos theta of ring t: float only.
template <typename T>
__device__ __forceinline__ T ct_low(const T* __restrict__ ctl, int t, bool valid) {
  if constexpr (HAS_LO<T>) return valid ? ctl[t] : T(0);
  else return T(0);
}

template <typename T> struct BulkStage {
  T a[2][MY][BLC], b[2][MY][BLC], e[2][MY][BLC];  // e: the wigner mode's c
  T nrm[2][BLC], hp[2][BLC];
};
// the coefficients a mode stages per chunk: a, b (e: all but scalar), and
// the degree norms in the Legendre spin modes
constexpr int BULK_NQ = MODE == SCALAR ? 2 : 3;
constexpr bool BULK_NORMS = MODE != SCALAR && MODE != WIGNER;
constexpr int BULK_NV = BULK_NQ * MY * BLC + (BULK_NORMS ? 2 * BLC : 0);

// Value k of the chunk starting at degree l0 for the block's m rows from m0:
// a, b, e [q][row][i] then nrm, hp [i]; zero from nl on and for rows >= nm.
template <typename T>
__device__ __forceinline__ T bulk_coef(const T* __restrict__ ab, const T* __restrict__ lt,
                                       int l0, int m0, int nl, int nm, int k) {
  constexpr int QS = MY * BLC;
  if (k < BULK_NQ * QS) {
    const int q = k / QS, row = (k % QS) / BLC, l = l0 + k % BLC, mm = m0 + row;
    return l < nl && mm < nm ? ab[((size_t)q * nl + l) * nm + mm] : T(0);
  }
  k -= BULK_NQ * QS;
  const int l = l0 + k % BLC;
  return l < nl ? lt[(k / BLC) * nl + l] : T(0);
}

template <typename T>
__device__ __forceinline__ void bulk_store(BulkStage<T>& sm, int buf, int k, T v) {
  constexpr int QS = MY * BLC;
  if (k < BULK_NQ * QS) {
    const int q = k / QS, row = (k % QS) / BLC, i = k % BLC;
    (q == 0 ? sm.a : q == 1 ? sm.b : sm.e)[buf][row][i] = v;
    return;
  }
  k -= BULK_NQ * QS;
  (k < BLC ? sm.nrm : sm.hp)[buf][k % BLC] = v;
}

// Reduce-scatter over the lanes xor O, O/2, .., 1 of N values w[0..N): each
// round with N > 1 keeps the half of the values that the lane's bit O
// selects and adds the partner's copy of it; with one value left, the
// rounds are a plain butterfly. The lane is left with N / (2 O) values (at
// least one), whole sums over the lanes, in w[0..).
template <int N, int O, typename T, int NW>
__device__ __forceinline__ void reduce_scatter(T (&w)[NW], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const T send = up ? w[j] : w[j + N / 2];
        const T keep = up ? w[j + N / 2] : w[j];
        w[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N / 2, O / 2>(w, lane);
    } else {
      w[0] += __shfl_xor_sync(0xffffffffu, w[0], O);
      reduce_scatter<1, O / 2>(w, lane);
    }
  }
}

// K2 (SYM) / K4: part[g, l, m, c] += sum over the rings t of the tiles of
// plane g of sum_f u_f(l, m, theta_t) F[f, c, m, t]. Full: F [NFUN, C, nm, nt].
// SYM: F is [NFUN, C, 2, nm, nt] with the even (north + south) and odd
// (north - south) combinations on the northern rings; function f of (l, m)
// takes the even plane where PSIGN[f] (-1)^(l+m) = +1. part
// [gridDim.x, nl, nm, C] must be zero on entry; ntiles counts the kernel's
// ring tiles (anal_lanes(R) R rings). ab [3, nl, nm]; lt [2, nl]; cth, ctl
// [nt]; rows [4, nt]; sv, sl [NBR, nm, nt]; spin is the wigner mode's s.
// lstop, the stop degrees [gridDim.y, ntiles], is read when STOPS, state
// [3, nm, nt] written when DUMP (each entry's state where its loop ended).
// The body of the kernels bulk_analysis_kernel (float) and
// bulk_analysis_kernel_f64 (double), below.
template <typename T, int C, bool SYM, int R, bool STOPS, bool DUMP>
__device__ __forceinline__ void
bulk_analysis(const T* __restrict__ F, const T* __restrict__ ab,
              const T* __restrict__ lt, const T* __restrict__ cth,
              const T* __restrict__ ctl, const T* __restrict__ rows,
              const T* __restrict__ sv, const int* __restrict__ sl,
              T* __restrict__ part, int nl, int nm, int nt, int ntiles,
              int spin, int mfirst, const int* __restrict__ lstop, T* __restrict__ state) {
  constexpr int LPR = anal_lanes(R);    // lanes of an m row
  constexpr int TW = LPR * R;           // rings of a tile
  constexpr int THREADS = MY * LPR;
  constexpr int KST = (BULK_NV + THREADS - 1) / THREADS;  // staged values per thread
  static_assert(BLC % BG == 0, "a chunk holds whole groups");
  constexpr int NV = BG * C;            // sums of a group
  constexpr int PER = NV >= LPR ? NV / LPR : 1;   // entries a lane is left with
  constexpr int DUP = NV >= LPR ? 1 : LPR / NV;   // lanes left with the same entry
  static_assert(LPR == 32 || LPR == 16, "a row is a warp or a half-warp");
  static_assert(!STOPS || TW == TX, "a block with stop degrees is one tile of the stop table");
  __shared__ BulkStage<T> sm;
  const int tid = threadIdx.x, row = tid / LPR, rl = tid % LPR;
  // the block's first row mb and the thread's row mi index the m block's
  // arrays; m = mfirst + mi is the row's true m
  const int mb = blockIdx.y * MY, mi = mb + row, m = mfirst + mi;
  const size_t plane = (size_t)nm * nt;
  const T sgs = (spin & 1) ? T(-1) : T(1);
  const int lbeg = MODE == WIGNER ? max(mfirst + mb, spin) : mfirst + mb;
  const int l8 = lbeg & ~7;  // groups start at multiples of 8
  const int lseed = seed_groups_end(l8, mfirst + mb, spin);
  // the lane's entries of a group after the butterfly: base .. base + PER - 1
  const bool writer = rl % DUP == 0;
  const int base = rl / DUP * PER;
  T* __restrict__ dst = part + (size_t)blockIdx.x * nl * nm * C;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int lend = STOPS ? stop_degree(lstop, blockIdx.y, tile, ntiles, nl) : nl;
    if (lend <= l8) continue;  // a dead tile, uniform over the block
    const int nch = (lend - l8 + BLC - 1) / BLC;
    Ring<T> ring[R];
    T xlo[R];
    Recur<T> rc[R];
    T fac[R][NBR];  // each state's level factor: 1 at level 0
    T fE[R][NFUN][C], fO[R][NFUN][C];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = tile * TW + rl + LPR * r;
      const bool valid = t < nt && mi < nm;
      const size_t mt = (size_t)mi * nt + t;
      ring[r] = load_ring(cth, rows, t, nt, valid);
      xlo[r] = ct_low(ctl, t, valid);
      rc[r] = load_recur(sv, sl, mt, plane, m, spin, valid);
#pragma unroll
      for (int br = 0; br < NBR; ++br) fac[r][br] = T(1);
#pragma unroll
      for (int f = 0; f < NFUN; ++f)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const size_t fc = (size_t)f * C + c;
          if (SYM) {
            const T ev = valid ? F[(2 * fc) * plane + mt] : T(0);
            const T od = valid ? F[(2 * fc + 1) * plane + mt] : T(0);
            // on odd m rows (l + m) is odd at even l: swap the planes, so
            // that degree i of a group reads fO where i is odd
            fE[r][f][c] = (m & 1) ? od : ev;
            fO[r][f][c] = (m & 1) ? ev : od;
          } else {
            fE[r][f][c] = valid ? F[fc * plane + mt] : T(0);
          }
        }
    }
    // the staging pipeline: chunk 0 into buffer 0, chunk 1 into registers
    T kv[KST];
#pragma unroll
    for (int k = 0; k < KST; ++k) {
      const int e = tid + k * THREADS;
      if (e < BULK_NV) {
        bulk_store(sm, 0, e, bulk_coef(ab, lt, l8, mb, nl, nm, e));
        kv[k] = bulk_coef(ab, lt, l8 + BLC, mb, nl, nm, e);
      }
    }
    __syncthreads();
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1, lc0 = l8 + ch * BLC;
      // one group of BG degrees from degree gl0 (chunk index gi0); TAIL: the
      // group the stop cuts, its degrees under a uniform test; SEED: the
      // groups that hold the seeds of the block's rows (they lie within 3
      // degrees of lbeg, and the first group starts at most 7 below it: one
      // group where the block starts on a multiple of MY, else at most two;
      // a group cut by a stop needs no other case)
      auto group = [&](int gl0, int gi0, auto tail, auto seed) {
        constexpr bool TAIL = decltype(tail)::value, SEED = decltype(seed)::value;
        T w[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) w[j] = T(0);
#pragma unroll
        for (int i = 0; i < BG; ++i) {
          const int l = gl0 + i, li = gi0 + i;
          if (TAIL && l >= lend) break;
          const T a = sm.a[buf][row][li], b = sm.b[buf][row][li];
          const T e = MODE != SCALAR ? sm.e[buf][row][li] : T(0);
          const T nrm = BULK_NORMS ? sm.nrm[buf][li] : T(0);
          const T hp = BULK_NORMS ? sm.hp[buf][li] : T(0);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            T u[NFUN];
            bulk_advance<SEED>(u, rc[r], fac[r], l, m, a, b, e, nrm, hp, ring[r], xlo[r], sgs);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              T tot = w[i * C + c];
#pragma unroll
              for (int f = 0; f < NFUN; ++f) {
                // the even plane where PSIGN[f] (-1)^(l+m) = +1; l + m has
                // the parity of i after the swap (SYM only)
                const bool even = !SYM || ((psign(f) > 0) != (i & 1));
                tot = fma_t(u[f], even ? fE[r][f][c] : fO[r][f][c], tot);
              }
              w[i * C + c] = tot;
            }
          }
          if (!TAIL && i == BG - 1) {  // l = 7 mod 8: renormalize
#pragma unroll
            for (int r = 0; r < R; ++r) {
              rescale(rc[r]);
#pragma unroll
              for (int br = 0; br < NBR; ++br) fac[r][br] = level_factor<T>(rc[r].s[br].lev);
            }
          }
        }
        reduce_scatter<NV, LPR / 2>(w, rl);
        if (writer && mi < nm) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int d = (base + k) / C, c = (base + k) % C, l = gl0 + d;
            // the same thread owns the same (l, m, c) in every tile of the plane
            if (l < lend) dst[((size_t)l * nm + mi) * C + c] += w[k];
          }
        }
      };
      for (int g = 0; g < BLC / BG; ++g) {
        const int gl0 = lc0 + g * BG;
        if (gl0 >= lend) break;
        // gl0 < lseed (l8 + BG where the block starts on a multiple of MY),
        // not the equivalent gl0 == l8: with the latter nvcc's code was
        // measured slower on an H100 in deriv and spin2 (chip_smoke.py
        // --phases variants; PERF.md section 6)
        if (gl0 + BG > lend)
          group(gl0, g * BG, std::true_type{}, std::true_type{});
        else if (gl0 < lseed)
          group(gl0, g * BG, std::false_type{}, std::true_type{});
        else
          group(gl0, g * BG, std::false_type{}, std::false_type{});
      }
      // the next chunk into the other buffer, the one after into registers
#pragma unroll
      for (int k = 0; k < KST; ++k) {
        const int e = tid + k * THREADS;
        if (e < BULK_NV) {
          if (ch + 1 < nch) bulk_store(sm, buf ^ 1, e, kv[k]);
          if (ch + 2 < nch) kv[k] = bulk_coef(ab, lt, l8 + (ch + 2) * BLC, mb, nl, nm, e);
        }
      }
      __syncthreads();
    }
    if constexpr (DUMP && MODE != WIGNER) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = tile * TW + rl + LPR * r;
        if (t < nt && mi < nm) dump_state(state, (size_t)mi * nt + t, plane, rc[r].s[0]);
      }
    }
  }
}

#define BULK_PARAMS(T)                                                                     \
  const T *__restrict__ X, const T *__restrict__ ab, const T *__restrict__ lt,             \
      const T *__restrict__ cth, const T *__restrict__ ctl, const T *__restrict__ rows,    \
      const T *__restrict__ sv, const int *__restrict__ sl, T *__restrict__ Y
#define BULK_PASS X, ab, lt, cth, ctl, rows, sv, sl, Y

// The float kernel: no minimum of blocks an SM in its launch bounds (capped
// at 128 registers, four blocks, its C = 4 forms of the spin modes spill up
// to 320 bytes). The double kernel takes no stop table and hands no state
// over, and its bounds ask for f64_analysis_blocks blocks an SM.
template <int C, bool SYM, int R, bool STOPS, bool DUMP>
__global__ void __launch_bounds__(MY * anal_lanes(R))
bulk_analysis_kernel(BULK_PARAMS(float), int nl, int nm, int nt, int ntiles, int spin,
                     int mfirst, const int* __restrict__ lstop, float* __restrict__ state) {
  bulk_analysis<float, C, SYM, R, STOPS, DUMP>(BULK_PASS, nl, nm, nt, ntiles, spin, mfirst, lstop,
                                               state);
}

template <int C, bool SYM, int R>
__global__ void __launch_bounds__(MY * anal_lanes(R), f64_analysis_blocks(C, SYM))
bulk_analysis_kernel_f64(BULK_PARAMS(double), int nl, int nm, int nt, int ntiles, int spin,
                         int mfirst) {
  bulk_analysis<double, C, SYM, R, false, false>(BULK_PASS, nl, nm, nt, ntiles, spin, mfirst,
                                                 nullptr, nullptr);
}

// K1 / K3, redesigned for Hopper (bulk_synthesis_kernel), in float32 and in
// float64: every launch of K1 and K3 (and K7's synthesis) takes it. It
// replaced synthesis_kernel, one ring a thread, ~25 instruction slots per
// (l, m, theta) triple in scalar mode and ~65 in spin2 where the arithmetic
// needs ~10 and ~37: the seed test and level select in every step, 3-5
// shared-memory loads of the coefficients and C of the alm per triple that
// no other ring shared, in the half-sky form a multiply, an add and a
// select-add per function and column for the mirror ring, and two barriers
// per 32 degrees around an unbuffered staging. Here:
//   - a thread carries R rings of one m row, whose independent recurrences
//     hide each other's latency: two in scalar mode (a warp is one m row of
//     a 64-ring tile), one in the spin modes, whose mode functions' registers
//     would otherwise leave too few warps (half a row a warp; float64:
//     f64_synthesis_rings);
//   - the coefficients and A of a degree are staged per m row as one record
//     (a, b, e, the norms, A[l, m, 0..C)), which the thread reads with 128-bit
//     shared-memory loads (four floats or two doubles each): one a degree in
//     float32 scalar mode at C = 2, where separate loads took three, and each
//     serves the thread's R rings;
//   - degree groups of BG = 8 start at multiples of 8 below the block's
//     first seed, so that the first group alone carries the seed test and
//     the level's factor changes only there and at a renormalization, the
//     group's last step (bulk_step, shared with bulk_analysis_kernel); a
//     group cut by the stop runs its degrees under a uniform test;
//   - in the half-sky form a degree's parity is known at compile time inside
//     a group: one FMA into the even-l or the odd-l sum E, O per function and
//     column, and once after the loop N = E + O and the mirror
//     S = PSIGN[f] (-1)^m (E - O);
//   - a block is one tile of the stop table (MY m rows x TX rings, the
//     half-sky form too, from the dead-tile table of its northern rings):
//     a dead tile writes zeros; the coefficients and A of a chunk of BLC
//     degrees are staged in shared memory, double-buffered, each thread
//     loading its share of the next chunk into registers before the current
//     chunk's work, with one barrier per chunk;
//   - STOPS and DUMP are template parameters: launches without a stop table
//     or a state handoff carry neither; with DUMP each ring's state is
//     written where its own loop ended, by the same arithmetic as without,
//     so the blocked split stays bit-identical below its handoffs. Float64
//     launches take neither.
// Rings per thread: see f32_synthesis_rings.
template <typename T, int C> constexpr int synth_rings() {
  return HAS_LO<T> ? f32_synthesis_rings() : f64_synthesis_rings(C);
}
// even/odd sums in the half-sky form, not north and mirror sums (measured by
// chip_smoke.py --phases variants)
constexpr bool SYNTH_EVEN_ODD = true;
// The record a thread reads per degree, staged per (m row, degree) of a
// chunk: the coefficients a, b (e: e_lm, the wigner mode's c), the degree
// norms nrm, hp (the Legendre spin modes), then A[l, m, 0..C), padded to
// whole 16-byte vectors of VEC values, so that a degree takes W / VEC
// 128-bit shared-memory loads.
template <typename T, int C> struct SynthRec {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int NC = BULK_NQ + (BULK_NORMS ? 2 : 0);  // coefficients
  static constexpr int W = (NC + C + VEC - 1) / VEC * VEC;     // values
};

template <typename T, int C> struct SynthStage {
  alignas(16) T rec[2][MY][BLC][SynthRec<T, C>::W];
};

// One 128-bit shared-memory load into v[0..16 / sizeof(T)).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x, v[1] = q.y;
}

// Value k of the chunk starting at degree l0 for the block's m rows from m0:
// a, b, e [q][i][row] (row fastest, so that neighbouring threads read
// neighbouring addresses), then nrm, hp [i], then A [i][row][c]; zero from
// nl on and for rows >= nm.
template <int C, typename T>
__device__ __forceinline__ T synth_coef(const T* __restrict__ ab, const T* __restrict__ lt,
                                        const T* __restrict__ A, int l0, int m0, int nl, int nm,
                                        int k) {
  constexpr int QS = MY * BLC;
  if (k < BULK_NQ * QS) {
    const int q = k / QS, l = l0 + (k / MY) % BLC, mm = m0 + k % MY;
    return l < nl && mm < nm ? ab[((size_t)q * nl + l) * nm + mm] : T(0);
  }
  k -= BULK_NQ * QS;
  if (BULK_NORMS) {
    if (k < 2 * BLC) {
      const int l = l0 + k % BLC;
      return l < nl ? lt[(k / BLC) * nl + l] : T(0);
    }
    k -= 2 * BLC;
  }
  const int l = l0 + k / (MY * C), j = k % (MY * C), mm = m0 + j / C;
  return l < nl && mm < nm ? A[((size_t)l * nm + m0) * C + j] : T(0);
}

// Store value k (synth_coef's order) into the records of buffer buf; a
// degree norm goes into the record of every row.
template <typename T, int C>
__device__ __forceinline__ void synth_store(SynthStage<T, C>& sm, int buf, int k, T v) {
  constexpr int QS = MY * BLC, NC = SynthRec<T, C>::NC;
  if (k < BULK_NQ * QS) {
    sm.rec[buf][k % MY][(k / MY) % BLC][k / QS] = v;
    return;
  }
  k -= BULK_NQ * QS;
  if (BULK_NORMS) {
    if (k < 2 * BLC) {
#pragma unroll
      for (int row = 0; row < MY; ++row) sm.rec[buf][row][k % BLC][BULK_NQ + k / BLC] = v;
      return;
    }
    k -= 2 * BLC;
  }
  const int j = k % (MY * C);
  sm.rec[buf][j / C][k / (MY * C)][NC + j % C] = v;
}

// K1 (SYM) / K3: G[f, c, m, t] = sum_l u_f(l, m, theta_t) A[l, m, c].
// A [nl, nm, C]; ab [3, nl, nm]; lt [2, nl]; cth, ctl [nt]; rows [4, nt];
// sv, sl [NBR, nm, nt]. Full: out [NFUN, C, nm, nt]. SYM: theta holds the
// northern rings of a south-symmetric ring set and out is
// [NFUN, C, 2, nm, nt] with plane 1 the mirror ring. spin is the wigner
// mode's s; lstop, the stop degrees [gridDim.y, gridDim.x] (the half-sky
// form's those of its northern rings), is read when STOPS, state [3, nm, nt]
// written when DUMP (each entry's state where its loop ended). The body of
// the kernels bulk_synthesis_kernel (float) and bulk_synthesis_kernel_f64
// (double), below.
template <typename T, int C, bool SYM, int R, bool STOPS, bool DUMP>
__device__ __forceinline__ void
bulk_synthesis(const T* __restrict__ A, const T* __restrict__ ab,
               const T* __restrict__ lt, const T* __restrict__ cth,
               const T* __restrict__ ctl, const T* __restrict__ rows,
               const T* __restrict__ sv, const int* __restrict__ sl,
               T* __restrict__ out, int nl, int nm, int nt, int spin, int mfirst,
               const int* __restrict__ lstop, T* __restrict__ state) {
  constexpr int LPR = TX / R;           // threads of an m row
  constexpr int THREADS = MY * LPR;
  constexpr int NV = BULK_NV + MY * BLC * C;  // staged per chunk: the coefficients, then A
  constexpr int KST = (NV + THREADS - 1) / THREADS;  // staged values per thread
  constexpr int NP = SYM ? 2 : 1;       // sums per function and column
  static_assert(BLC % BG == 0, "a chunk holds whole groups");
  __shared__ SynthStage<T, C> sm;
  const int tid = threadIdx.x, row = tid / LPR, rl = tid % LPR;
  // mb and mi index the m block's arrays, m = mfirst + mi is the true m
  const int tile = blockIdx.x, mb = blockIdx.y * MY, mi = mb + row, m = mfirst + mi;
  const size_t plane = (size_t)nm * nt;
  const T sgs = (spin & 1) ? T(-1) : T(1);
  const int lbeg = MODE == WIGNER ? max(mfirst + mb, spin) : mfirst + mb;
  const int l8 = lbeg & ~7;  // groups start at multiples of 8
  const int lseed = seed_groups_end(l8, mfirst + mb, spin);
  const int lend = STOPS ? stop_degree(lstop, blockIdx.y, tile, gridDim.x, nl) : nl;
  // a dead tile (or one whose stop comes before any group) runs no chunk
  const int nch = lend > l8 ? (lend - l8 + BLC - 1) / BLC : 0;
  Ring<T> ring[R];
  T xlo[R];
  Recur<T> rc[R];
  T fac[R][NBR];  // each state's level factor: 1 at level 0
  // SYM: the even-l and odd-l sums E, O (SYNTH_EVEN_ODD), or the north and
  // mirror sums; full: one sum
  T acc[R][NFUN][C][NP];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = tile * TX + rl + LPR * r;
    const bool valid = t < nt && mi < nm;
    ring[r] = load_ring(cth, rows, t, nt, valid);
    xlo[r] = ct_low(ctl, t, valid);
    rc[r] = load_recur(sv, sl, (size_t)mi * nt + t, plane, m, spin, valid);
#pragma unroll
    for (int br = 0; br < NBR; ++br) fac[r][br] = T(1);
#pragma unroll
    for (int f = 0; f < NFUN; ++f)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int p = 0; p < NP; ++p) acc[r][f][c][p] = T(0);
  }
  if (nch > 0) {  // uniform over the block
    // the staging pipeline: chunk 0 into buffer 0, chunk 1 into registers
    T kv[KST];
#pragma unroll
    for (int k = 0; k < KST; ++k) {
      const int e = tid + k * THREADS;
      if (e < NV) {
        synth_store(sm, 0, e, synth_coef<C>(ab, lt, A, l8, mb, nl, nm, e));
        kv[k] = synth_coef<C>(ab, lt, A, l8 + BLC, mb, nl, nm, e);
      }
    }
    __syncthreads();
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1, lc0 = l8 + ch * BLC;
      // one group of BG degrees from degree gl0 (chunk index gi0); TAIL: the
      // group the stop cuts, its degrees under a uniform test; SEED: the
      // groups that hold the seeds of the block's rows (below lseed)
      auto group = [&](int gl0, int gi0, auto tail, auto seed) {
        constexpr bool TAIL = decltype(tail)::value, SEED = decltype(seed)::value;
#pragma unroll
        for (int i = 0; i < BG; ++i) {
          const int l = gl0 + i, li = gi0 + i;
          if (TAIL && l >= lend) break;
          // the degree's record in W / VEC 128-bit loads
          constexpr int W = SynthRec<T, C>::W, NC = SynthRec<T, C>::NC;
          constexpr int VEC = SynthRec<T, C>::VEC;
          T rv[W];
#pragma unroll
          for (int j = 0; j < W; j += VEC) load16(&sm.rec[buf][row][li][j], &rv[j]);
          const T a = rv[0], b = rv[1];
          const T e = MODE != SCALAR ? rv[2] : T(0);
          const T nrm = BULK_NORMS ? rv[BULK_NQ] : T(0);
          const T hp = BULK_NORMS ? rv[BULK_NQ + 1] : T(0);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            T u[NFUN];
            bulk_advance<SEED>(u, rc[r], fac[r], l, m, a, b, e, nrm, hp, ring[r], xlo[r], sgs);
#pragma unroll
            for (int f = 0; f < NFUN; ++f)
#pragma unroll
              for (int c = 0; c < C; ++c) {
                if constexpr (SYM && SYNTH_EVEN_ODD) {
                  // l has the parity of i: gl0 is a multiple of 8
                  acc[r][f][c][i & 1] = fma_t(u[f], rv[NC + c], acc[r][f][c][i & 1]);
                } else if constexpr (SYM) {
                  // the mirror ring's sign, PSIGN[f] (-1)^(l+m)
                  const T v = u[f] * rv[NC + c];
                  const bool plus = (psign(f) > 0) != (((i + m) & 1) != 0);
                  acc[r][f][c][0] += v;
                  acc[r][f][c][1] += plus ? v : -v;
                } else {
                  acc[r][f][c][0] = fma_t(u[f], rv[NC + c], acc[r][f][c][0]);
                }
              }
          }
          if (!TAIL && i == BG - 1) {  // l = 7 mod 8: renormalize
#pragma unroll
            for (int r = 0; r < R; ++r) {
              rescale(rc[r]);
#pragma unroll
              for (int br = 0; br < NBR; ++br) fac[r][br] = level_factor<T>(rc[r].s[br].lev);
            }
          }
        }
      };
      for (int g = 0; g < BLC / BG; ++g) {
        const int gl0 = lc0 + g * BG;
        if (gl0 >= lend) break;
        // gl0 < lseed rather than gl0 == l8, as in bulk_analysis_kernel
        if (gl0 + BG > lend)
          group(gl0, g * BG, std::true_type{}, std::true_type{});
        else if (gl0 < lseed)
          group(gl0, g * BG, std::false_type{}, std::true_type{});
        else
          group(gl0, g * BG, std::false_type{}, std::false_type{});
      }
      // the next chunk into the other buffer, the one after into registers
#pragma unroll
      for (int k = 0; k < KST; ++k) {
        const int e = tid + k * THREADS;
        if (e < NV) {
          if (ch + 1 < nch) synth_store(sm, buf ^ 1, e, kv[k]);
          if (ch + 2 < nch) kv[k] = synth_coef<C>(ab, lt, A, l8 + (ch + 2) * BLC, mb, nl, nm, e);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = tile * TX + rl + LPR * r;
    if (t >= nt || mi >= nm) continue;
    const size_t mt = (size_t)mi * nt + t;
    if constexpr (DUMP && MODE != WIGNER) dump_state(state, mt, plane, rc[r].s[0]);
#pragma unroll
    for (int f = 0; f < NFUN; ++f)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t fc = (size_t)f * C + c;
        if constexpr (SYM) {
          T north = acc[r][f][c][0], mirror = acc[r][f][c][1];
          if constexpr (SYNTH_EVEN_ODD) {
            // N = E + O; S = PSIGN[f] (-1)^m (E - O)
            const T d = north - mirror;
            north += mirror;
            mirror = (psign(f) > 0) == ((m & 1) == 0) ? d : -d;
          }
          out[(2 * fc) * plane + mt] = north;
          out[(2 * fc + 1) * plane + mt] = mirror;
        } else {
          out[fc * plane + mt] = acc[r][f][c][0];
        }
      }
  }
}

// The float kernel's launch bounds give the threads alone; the double
// kernel takes no stop table and hands no state over, and its bounds ask
// for f64_synthesis_blocks blocks an SM.
template <int C, bool SYM, int R, bool STOPS, bool DUMP>
__global__ void __launch_bounds__(MY * TX / R)
bulk_synthesis_kernel(BULK_PARAMS(float), int nl, int nm, int nt, int spin, int mfirst,
                      const int* __restrict__ lstop, float* __restrict__ state) {
  bulk_synthesis<float, C, SYM, R, STOPS, DUMP>(BULK_PASS, nl, nm, nt, spin, mfirst, lstop, state);
}

template <int C, bool SYM, int R>
__global__ void __launch_bounds__(MY * TX / R, f64_synthesis_blocks(C))
bulk_synthesis_kernel_f64(BULK_PARAMS(double), int nl, int nm, int nt, int spin, int mfirst) {
  bulk_synthesis<double, C, SYM, R, false, false>(BULK_PASS, nl, nm, nt, spin, mfirst, nullptr,
                                                  nullptr);
}

// K4's float64 near-pole pass, redesigned for Hopper (polar_analysis_kernel):
// out[l, m, c] = sum_t sum_f u_f(l, m, theta_t) F[f, c, m, t] on a small ring
// set near the poles (78 rings at lmax 750) for m < 128, in float64 only. The
// work is tiny (~10 us of FP64 at the data-sheet rate for spin2); what bounds
// it is the latency of ~lmax dependent recurrence steps per entry, with one
// warp of such chains per SM sub-partition. analysis_kernel's layout (4 m
// rows x 64 rings per block, one warp butterfly per degree and column)
// filled 64 of 132 SMs, left 39 % of its lanes idle on 78 rings and spent 5
// shuffle rounds per degree and column. Here:
//   - one block per m row (128 blocks), so each (l, m, c) has one owner: no
//     partial planes, no atomics, no zero-initialized buffer; the block
//     writes its rows l < its seed degree as zeros itself;
//   - warps 0-3 (producers) are one ring each of a PTILE-ring tile and run
//     nothing but the recurrence (polar_produce, shared with
//     polar_synthesis_kernel), PLC degrees at a time, each step's
//     coefficients read PLOOK steps ahead and the seed test only in the
//     first chunk; they hand lambda_l (and lambda_{l-1}; wigner: w and x)
//     over through a shared tile U[PLC][2][PTILE];
//   - warps 4-7 (reducers) own (l, c) outputs: thread (li, part) evaluates
//     the mode functions (their select form) of its degree on PTILE/PPARTS
//     rings of the tile (ring rows and F staged once per tile) and sums
//     them against F with two
//     partial sums per column; the PPARTS parts of a degree meet in two
//     shuffle rounds, once per chunk and not once per degree;
//   - U is double-buffered (the coefficients triple-buffered), so the
//     reducers work on chunk k while the producers run chunk k + 1: one
//     barrier per chunk, and a chunk takes the longer of the two; the
//     reducers also stage the coefficients, loading each chunk's from device
//     memory two chunks ahead;
//   - more than PTILE rings loop over ring tiles inside the block, each tile
//     adding into the block's own output rows (read back by the same thread);
//     warps and reducer iterations with no ring of the tile are skipped.
// Shared memory is dynamic (~152 KB in spin2: U 130 KB). U's degree rows are
// padded to PPARTS mod 16 doubles, so the reducers' loads (16/PPARTS degrees
// x PPARTS rings per half-warp) hit distinct banks; F is stored as column
// pairs, so consecutive rings read contiguous 16-byte pairs.
constexpr int PTILE = 128;             // rings per tile: one producer thread each
constexpr int PLC = 32;                // degrees per chunk
constexpr int PPARTS = PTILE / PLC;    // reducer threads per degree
constexpr int PTHREADS = 2 * PTILE;    // producers, then reducers
// a degree row of U, padded so that the reducers' loads of one half-warp
// (16 / PPARTS degrees x PPARTS rings) fall in distinct banks
constexpr int PROW = NFUN * PTILE + PPARTS;
static_assert(PLC * PPARTS == PTILE && PPARTS <= 16 && PROW % 16 == PPARTS,
              "reducer layout");

template <int C> struct PolarSmem {
  double U[2][PLC][PROW];         // what the producers hand over, double-buffered
  double2 F[NFUN][C / 2][PTILE];  // the tile's ring data, as column pairs
  double ring[7][PTILE];          // the tile's ring rows (Ring), for the reducers
  double cs[3][5][PLC];           // a, b, e (wigner: c), nrm, hp of a chunk
};

// Coefficient e = q PLC + i of a chunk starting at degree l0 (q: a, b, e or
// the wigner mode's c, nrm, hp; i: the degree in the chunk); zero below the
// seed degree lbeg, where the state stays zero, and from nl on; mi is the
// row in the m block.
__device__ __forceinline__ double polar_coef(const double* __restrict__ ab,
                                             const double* __restrict__ lt, int l0, int lbeg,
                                             int mi, int nl, int nm, int e) {
  const int q = e / PLC, l = l0 + e % PLC;
  const size_t nlm = (size_t)nl * nm, lm = (size_t)l * nm + mi;
  if (l < lbeg || l >= nl) return 0.0;
  if (q < 2) return ab[q * nlm + lm];
  if (q == 2) return MODE != SCALAR ? ab[2 * nlm + lm] : 0.0;
  return lt[(q - 3) * nl + l];
}
// a reducer thread stages coefficients rid and rid + PTILE of each chunk
constexpr int PCOEF = (5 * PLC + PTILE - 1) / PTILE;

// One step of the near-pole recurrence at degree l: bulk_step<double> with
// the level factor computed in the step (x: cos theta; cadd: the wigner
// mode's +c or -c). Returns the true lambda_l and sets lam1 to the true
// lambda_{l-1}, as bulk_step does, and rounds as it does. Without SEED the
// step leaves out the seed test: for the degrees past the seed.
template <bool SEED = true>
__device__ __forceinline__ double polar_step(State<double>& s, int l, int lseed, double a,
                                             double b, double x, double cadd, double seedv,
                                             int seedl, double& lam1) {
  double t = x * s.curr;
  if constexpr (MODE == WIGNER) t = fma(cadd, s.curr, t);
  double nw = a * (t - b * s.prev);
  double cz = s.curr;
  if (SEED && l == lseed) {  // seed; the stale previous value has another scale
    nw = seedv;
    s.lev = seedl;
    cz = 0.0;
  }
  s.prev = cz;
  s.curr = nw;
  const double fac = s.lev == 0 ? 1.0 : (s.lev == -1 ? Scale<double>::invband() : 0.0);
  lam1 = cz * fac;
  return nw * fac;
}

// the Legendre spin modes hand lambda_l and lambda_{l-1} over and the
// consumers evaluate the mode functions; scalar hands lambda_l, wigner w, x
constexpr bool POLAR_SPLIT = MODE == DERIV || MODE == SPIN1 || MODE == SPIN2;
constexpr int PLOOK = 4;  // steps a producer loads its coefficients ahead

// The producer half of both near-pole kernels: thread tid, one ring of a
// TW-ring tile at cos theta = x, advances its recurrence over the n degrees
// of the chunk starting at l0 (a multiple of 8; with SEED the chunk that
// holds the seed degree, the first, else one past it: its steps then skip
// the seed test, which would sit on the recurrence's chain) and hands the results over
// through the shared tile U (rows of stride ROW): lambda_l at U[i][tid] and,
// in the spin modes, lambda_{l-1} at U[i][TW + tid]; in wigner mode w and x
// there (sgs = (-1)^s). cs holds the chunk's coefficients a, b and e (wigner:
// c).
template <bool SEED, int TW, int ROW>
__device__ __forceinline__ void polar_produce(Recur<double>& rc, double x, double sgs,
                                              const double (&cs)[5][PLC],
                                              double (&U)[PLC][ROW], int l0, int n, int tid) {
  // a step's coefficients a, b (and the wigner mode's c)
  auto coef = [&](int i, double (&k)[3]) {
#pragma unroll
    for (int q = 0; q < 3; ++q) k[q] = cs[q][i];
  };
  auto produce = [&](int i, const double (&k)[3]) {
    const int l = l0 + i;
    double lam1;
    if constexpr (MODE == WIGNER) {
      const double lp = polar_step<SEED>(rc.s[0], l, rc.lseed, k[0], k[1], x, k[2],
                                         rc.seedv[0], rc.seedl[0], lam1);
      const double lm = sgs * polar_step<SEED>(rc.s[NBR - 1], l, rc.lseed, k[0], k[1], x,
                                               -k[2], rc.seedv[NBR - 1], rc.seedl[NBR - 1],
                                               lam1);
      U[i][tid] = 0.5 * (lp + lm);
      U[i][TW + tid] = 0.5 * (lp - lm);
    } else {
      U[i][tid] = polar_step<SEED>(rc.s[0], l, rc.lseed, k[0], k[1], x, 0.0, rc.seedv[0],
                                   rc.seedl[0], lam1);
      if constexpr (POLAR_SPLIT) U[i][TW + tid] = lam1;
    }
    if ((i & 7) == 7) rescale(rc);  // l & 7, as l0 is a multiple of 8
  };
  if (n == PLC) {
    // unrolled, and each step's coefficients loaded PLOOK steps ahead into
    // registers: the compiler may not move the loads across the stores to
    // U, and a shared-memory load takes longer than a step (two dependent
    // FP64 operations of ~8 cycles), so with less lookahead the chain
    // waits on shared memory
    double kb[PLOOK][3];
#pragma unroll
    for (int j = 0; j < PLOOK; ++j) coef(j, kb[j]);
#pragma unroll
    for (int i = 0; i < PLC; ++i) {
      double k[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) k[q] = kb[i % PLOOK][q];
      if (i + PLOOK < PLC) coef(i + PLOOK, kb[i % PLOOK]);
      produce(i, k);
    }
  } else {  // the last, partial chunk
    for (int i = 0; i < n; ++i) {
      double k[3];
      coef(i, k);
      produce(i, k);
    }
  }
}

// F [NFUN, C, nm, nt] -> out[l, m, c] at column stride ldo (>= C), for the m
// row of this block; out's rows l < the seed degree are written as zeros.
// ab [3, nl, nm]; lt [2, nl]; cth [nt]; rows [4, nt]; sv, sl [NBR, nm, nt];
// spin is the wigner mode's s.
template <int C>
__global__ void __launch_bounds__(PTHREADS, 1)
polar_analysis_kernel(const double* __restrict__ F, const double* __restrict__ ab,
                      const double* __restrict__ lt, const double* __restrict__ cth,
                      const double* __restrict__ rows, const double* __restrict__ sv,
                      const int* __restrict__ sl, double* __restrict__ out, int ldo, int nl,
                      int nm, int nt, int spin, int mfirst) {
  constexpr bool SPLIT = POLAR_SPLIT;
  extern __shared__ __align__(16) unsigned char polar_raw[];
  PolarSmem<C>& sm = *reinterpret_cast<PolarSmem<C>*>(polar_raw);
  // mi indexes the m block's arrays, m = mfirst + mi is the true m
  const int tid = threadIdx.x, mi = blockIdx.x, m = mfirst + mi;
  const bool producer = tid < PTILE;
  const int rid = tid - PTILE;                  // reducer index
  const int li = rid / PPARTS, part = rid % PPARTS;
  const size_t plane = (size_t)nm * nt;
  const double sgs = (spin & 1) ? -1.0 : 1.0;
  const int lbeg = MODE == WIGNER ? max(m, spin) : m;
  // chunks start at multiples of 8 from below the seed, so that the
  // renormalization every 8 degrees falls on fixed steps of the unrolled
  // chunk and no step but every eighth ends in a branch
  const int l8 = lbeg & ~7;
  const int ntiles = (nt + PTILE - 1) / PTILE;
  const int nch = nl > lbeg ? (nl - l8 + PLC - 1) / PLC : 0;
  const int lz = ntiles == 0 ? nl : min(lbeg, nl);
  for (int i = tid; i < lz * C; i += PTHREADS)
    out[((size_t)(i / C) * nm + mi) * ldo + i % C] = 0.0;
  if (nch == 0) return;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t = tile * PTILE + tid;
    const bool valid = producer && t < nt;
    const double x = valid ? cth[t] : 0.0;
    Recur<double> rc = load_recur(sv, sl, (size_t)mi * nt + t, plane, m, spin, valid);
    // a reducer's coefficients of the chunk after next, loaded from device
    // memory one iteration before they are staged, so their latency overlaps
    // the reduction instead of stalling it
    double kv[PCOEF];
    if (!producer) {
      for (int i = rid; i < NFUN * (C / 2) * PTILE; i += PTILE) {
        const int rr = i % PTILE, fc = i / PTILE, f = fc / (C / 2), cp = fc % (C / 2);
        const int tt = tile * PTILE + rr;
        const size_t at = ((size_t)(f * C + 2 * cp) * nm + mi) * nt + tt;
        sm.F[f][cp][rr] = tt < nt ? make_double2(F[at], F[at + plane]) : make_double2(0.0, 0.0);
      }
      if (SPLIT) {
        const int tt = tile * PTILE + rid;
        const Ring<double> q = load_ring(cth, rows, tt, nt, tt < nt);
        sm.ring[0][rid] = q.ct, sm.ring[1][rid] = q.ct_st, sm.ring[2][rid] = q.inv_st;
        sm.ring[3][rid] = q.inv_st2, sm.ring[4][rid] = q.notpole, sm.ring[5][rid] = q.pn;
        sm.ring[6][rid] = q.ps;
      }
#pragma unroll
      for (int k = 0; k < PCOEF; ++k) {
        const int e = rid + k * PTILE;
        if (e < 5 * PLC) {
          sm.cs[0][e / PLC][e % PLC] = polar_coef(ab, lt, l8, lbeg, mi, nl, nm, e);
          kv[k] = polar_coef(ab, lt, l8 + PLC, lbeg, mi, nl, nm, e);
        }
      }
    }
    __syncthreads();
    // rings of this tile; a producer warp with none of them skips its steps
    const int nvalid = min(PTILE, nt - tile * PTILE);
    const bool live = (tid & ~31) < nvalid;
    for (int it = 0; it <= nch; ++it) {
      if (producer) {
        if (it < nch && live) {
          const int l0 = l8 + it * PLC, n = min(PLC, nl - l0);
          if (it == 0)
            polar_produce<true, PTILE, PROW>(rc, x, sgs, sm.cs[0], sm.U[0], l0, n, tid);
          else
            polar_produce<false, PTILE, PROW>(rc, x, sgs, sm.cs[it % 3], sm.U[it & 1], l0, n,
                                              tid);
        }
      } else {
#pragma unroll
        for (int k = 0; k < PCOEF; ++k) {
          const int e = rid + k * PTILE;
          if (e < 5 * PLC) {
            if (it + 1 < nch) sm.cs[(it + 1) % 3][e / PLC][e % PLC] = kv[k];
            if (it + 2 < nch) kv[k] = polar_coef(ab, lt, l8 + (it + 2) * PLC, lbeg, mi, nl, nm, e);
          }
        }
        if (it >= 1) {
          const int l0 = l8 + (it - 1) * PLC, l = l0 + li;
          const double(&cs)[5][PLC] = sm.cs[(it - 1) % 3];
          const double* __restrict__ U = sm.U[(it - 1) & 1][li];
          double acc[2][C];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[0][c] = acc[1][c] = 0.0;
#pragma unroll
          for (int j = 0; j < PTILE / PPARTS; ++j) {
            if (PPARTS * j >= nvalid) break;  // the rest of the tile is padding
            const int tt = part + PPARTS * j;
            double u[NFUN];
            if constexpr (SPLIT) {
              const Ring<double> q{sm.ring[0][tt], sm.ring[1][tt], sm.ring[2][tt],
                                   sm.ring[3][tt], sm.ring[4][tt], sm.ring[5][tt],
                                   sm.ring[6][tt]};
              mode_funcs<true>(u, U[tt], U[PTILE + tt], l, m, cs[2][li], cs[3][li], cs[4][li],
                               q);
            } else {
#pragma unroll
              for (int f = 0; f < NFUN; ++f) u[f] = U[f * PTILE + tt];
            }
#pragma unroll
            for (int f = 0; f < NFUN; ++f) {
#pragma unroll
              for (int cp = 0; cp < C / 2; ++cp) {
                const double2 v = sm.F[f][cp][tt];
                acc[j & 1][2 * cp] = fma(u[f], v.x, acc[j & 1][2 * cp]);
                acc[j & 1][2 * cp + 1] = fma(u[f], v.y, acc[j & 1][2 * cp + 1]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            double v = acc[0][c] + acc[1][c];
#pragma unroll
            for (int o = PPARTS / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            // the same thread owns the same (l, m, c) in every tile
            if (part == 0 && l >= lbeg && l < nl) {
              double* dst = out + ((size_t)(l0 + li) * nm + mi) * ldo + c;
              *dst = tile == 0 ? v : *dst + v;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// K3's float64 near-pole pass, redesigned for Hopper (polar_synthesis_kernel):
// G[f, c, m, t] = sum_l u_f(l, m, theta_t) A[l, m, c] on a small ring set
// near the poles (46 rings at lmax 750) for m < 128, in float64 only. What
// bounds it is, as for polar_analysis, the latency of ~lmax dependent
// recurrence steps per (m, ring), not the number of rings (two dependent
// FP64 operations a step). In spin2 the consumers' FP64 arithmetic comes
// close to it (~25 operations per (l, m, theta) for the mode functions, 8
// FMAs for the 2 x 4 sums). synthesis_kernel ran 32 blocks of 4 m rows x 64
// rings (18 of 64 lanes idle on 46 rings), put the mode functions and
// accumulations on the recurrence's chain and stalled every block on two
// barriers and an unprefetched staging per 32 degrees. Here:
//   - one block per m row (128 blocks), each output (f, c, m, t) with one
//     owner; a row whose seed degree exceeds lmax is written as zeros;
//   - warps 0-1 (producers) are one ring each of an STILE-ring tile and run
//     nothing but the recurrence (polar_produce, shared with
//     polar_analysis_kernel: coefficients loaded PLOOK steps ahead, the
//     seed test only in the first chunk, so that neither sits on the chain);
//   - warps 2-7 (consumers) own (ring, degree part) pairs: lane = 4 r + p
//     takes degrees p, p + 4, ... of each chunk on ring r of its group of 8,
//     evaluates the mode functions there from its ring rows (loaded once per
//     tile into registers) and the handed-over values, and accumulates
//     u_f A[l, m, c] into registers kept across all chunks; A is staged per
//     chunk, and the lanes of a degree read the same entry (a broadcast).
//     A full chunk's degrees are unrolled without a branch between them (the
//     mode functions in their select form), so that their independent
//     arithmetic interleaves. The 4 parts of a ring meet in two shuffle
//     rounds once per tile;
//   - U is double-buffered and the coefficients and A triple-buffered, each
//     consumer loading its share of a chunk from device memory two chunks
//     ahead; chunks start at multiples of 8 (the renormalization falls on
//     fixed steps); more than STILE rings loop over ring tiles in the block.
// Shared memory is dynamic (~73 KB in spin2, U 66 KB). U's rows are padded to
// 4 mod 16 doubles, so a half-warp's loads (4 degrees x 4 rings) fall in
// distinct banks.
constexpr int STILE = 64;                          // rings per tile: one producer thread each
constexpr int SCONS = 192;                         // consumer threads: 6 warps
constexpr int STHREADS = STILE + SCONS;
constexpr int SPARTS = 4;                          // degree parts of a ring
constexpr int SRPW = 32 / SPARTS;                  // rings of a consumer warp's group
constexpr int SGROUPS = STILE / SRPW;              // ring groups of a tile
constexpr int SSLOTS = (SGROUPS + SCONS / 32 - 1) / (SCONS / 32);  // groups per consumer warp
constexpr int SROW = NFUN * STILE + 4;             // a degree row of U
static_assert(STILE % 32 == 0 && SCONS % 32 == 0 && SROW % 16 == 4 && PLC % SPARTS == 0,
              "consumer layout");

template <int C> struct PolarSynthSmem {
  double U[2][PLC][SROW];  // what the producers hand over, double-buffered
  double cs[3][5][PLC];    // a, b, e (wigner: c), nrm, hp of a chunk
  double A[3][PLC][C];     // A[l, m, :] of a chunk
};

// Staged value e of the chunk starting at l0: coefficient e (polar_coef) for
// e < 5 PLC, else A[l0 + i, mi, c] with e - 5 PLC = i C + c, zero outside
// lbeg <= l < nl; mi is the row in the m block. A's columns are at stride lda.
template <int C>
__device__ __forceinline__ double synth_stage_value(const double* __restrict__ ab,
                                                    const double* __restrict__ lt,
                                                    const double* __restrict__ A, int lda,
                                                    int l0, int lbeg, int mi, int nl, int nm,
                                                    int e) {
  if (e < 5 * PLC) return polar_coef(ab, lt, l0, lbeg, mi, nl, nm, e);
  e -= 5 * PLC;
  const int l = l0 + e / C;
  return l >= lbeg && l < nl ? A[((size_t)l * nm + mi) * lda + e % C] : 0.0;
}

template <int C>
__device__ __forceinline__ void synth_stage_store(PolarSynthSmem<C>& sm, int buf, int e,
                                                  double v) {
  if (e < 5 * PLC) {
    sm.cs[buf][e / PLC][e % PLC] = v;
  } else {
    e -= 5 * PLC;
    sm.A[buf][e / C][e % C] = v;
  }
}

// A [nl, nm, lda] (columns 0..C-1 read) -> out[f, c, m, t] at out +
// ((f ldo + c) nm + m) nt + t, for the m row of this block. ab [3, nl, nm];
// lt [2, nl]; cth [nt]; rows [4, nt]; sv, sl [NBR, nm, nt]; spin is the
// wigner mode's s.
template <int C>
__global__ void __launch_bounds__(STHREADS, 1)
polar_synthesis_kernel(const double* __restrict__ A, const double* __restrict__ ab,
                       const double* __restrict__ lt, const double* __restrict__ cth,
                       const double* __restrict__ rows, const double* __restrict__ sv,
                       const int* __restrict__ sl, double* __restrict__ out, int lda, int ldo,
                       int nl, int nm, int nt, int spin, int mfirst) {
  constexpr int NST = 5 * PLC + PLC * C;            // values staged per chunk
  constexpr int KST = (NST + SCONS - 1) / SCONS;    // of them per consumer
  extern __shared__ __align__(16) unsigned char polar_raw[];
  PolarSynthSmem<C>& sm = *reinterpret_cast<PolarSynthSmem<C>*>(polar_raw);
  // mi indexes the m block's arrays, m = mfirst + mi is the true m
  const int tid = threadIdx.x, mi = blockIdx.x, m = mfirst + mi;
  const bool producer = tid < STILE;
  const int cid = tid - STILE, cw = cid >> 5;       // consumer index and warp
  const int lane = tid & 31, part = lane % SPARTS, r = lane / SPARTS;
  const size_t plane = (size_t)nm * nt;
  const double sgs = (spin & 1) ? -1.0 : 1.0;
  const int lbeg = MODE == WIGNER ? max(m, spin) : m;
  const int l8 = lbeg & ~7;  // chunks start at multiples of 8, as in polar_analysis
  const int nch = nl > lbeg ? (nl - l8 + PLC - 1) / PLC : 0;
  double* __restrict__ orow = out + (size_t)mi * nt;
  const size_t fstride = (size_t)ldo * plane;       // from function f to f + 1
  if (nch == 0) {  // the seed lies beyond lmax: the row is zero
    for (int i = tid; i < NFUN * C * nt; i += STHREADS)
      orow[(i / (C * nt)) * fstride + (i / nt % C) * plane + i % nt] = 0.0;
    return;
  }
  const int ntiles = (nt + STILE - 1) / STILE;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * STILE, nvalid = min(STILE, nt - t0);
    const int t = t0 + tid;
    const bool valid = producer && t < nt;
    const double x = valid ? cth[t] : 0.0;
    Recur<double> rc = load_recur(sv, sl, (size_t)mi * nt + t, plane, m, spin, valid);
    // a consumer's slots: ring groups cw, cw + 6, ...; a slot is live when its
    // group holds a ring of the tile (the same for the whole warp)
    bool slive[SSLOTS];
    Ring<double> ring[SSLOTS];
    double acc[SSLOTS][NFUN][C];
    double kv[KST];  // a consumer's share of the chunk after next
#pragma unroll
    for (int s = 0; s < SSLOTS; ++s) {
      const int g = cw + s * (SCONS / 32);
      slive[s] = !producer && g < SGROUPS && g * SRPW < nvalid;
      const int tt = t0 + g * SRPW + r;
      ring[s] = load_ring(cth, rows, tt, nt, slive[s] && tt < nt);
#pragma unroll
      for (int f = 0; f < NFUN; ++f)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[s][f][c] = 0.0;
    }
    if (!producer) {
#pragma unroll
      for (int k = 0; k < KST; ++k) {
        const int e = cid + k * SCONS;
        if (e < NST) {
          synth_stage_store(sm, 0, e, synth_stage_value<C>(ab, lt, A, lda, l8, lbeg, mi, nl, nm, e));
          kv[k] = synth_stage_value<C>(ab, lt, A, lda, l8 + PLC, lbeg, mi, nl, nm, e);
        }
      }
    }
    __syncthreads();
    // a producer warp with no ring of this tile skips its steps
    const bool live = (tid & ~31) < nvalid;
    for (int it = 0; it <= nch; ++it) {
      if (producer) {
        if (it < nch && live) {
          const int l0 = l8 + it * PLC, n = min(PLC, nl - l0);
          if (it == 0)
            polar_produce<true, STILE, SROW>(rc, x, sgs, sm.cs[0], sm.U[0], l0, n, tid);
          else
            polar_produce<false, STILE, SROW>(rc, x, sgs, sm.cs[it % 3], sm.U[it & 1], l0, n,
                                              tid);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KST; ++k) {
          const int e = cid + k * SCONS;
          if (e < NST) {
            if (it + 1 < nch) synth_stage_store(sm, (it + 1) % 3, e, kv[k]);
            if (it + 2 < nch)
              kv[k] = synth_stage_value<C>(ab, lt, A, lda, l8 + (it + 2) * PLC, lbeg, mi, nl, nm, e);
          }
        }
        if (it >= 1) {
          const int l0 = l8 + (it - 1) * PLC, n = min(PLC, nl - l0);
          const double(&cs)[5][PLC] = sm.cs[(it - 1) % 3];
          const double(&Ac)[PLC][C] = sm.A[(it - 1) % 3];
          const double(&U)[PLC][SROW] = sm.U[(it - 1) & 1];
#pragma unroll
          for (int s = 0; s < SSLOTS; ++s) {
            if (!slive[s]) continue;  // warp-uniform, once per slot and chunk
            const int tt = (cw + s * (SCONS / 32)) * SRPW + r;
            // degree i of the chunk into the slot's sums
            auto consume = [&](int i) {
              double u[NFUN];
              if constexpr (POLAR_SPLIT) {
                mode_funcs<true>(u, U[i][tt], U[i][STILE + tt], l0 + i, m, cs[2][i], cs[3][i],
                           cs[4][i], ring[s]);
              } else {
#pragma unroll
                for (int f = 0; f < NFUN; ++f) u[f] = U[i][f * STILE + tt];
              }
#pragma unroll
              for (int f = 0; f < NFUN; ++f)
#pragma unroll
                for (int c = 0; c < C; ++c) acc[s][f][c] = fma(u[f], Ac[i][c], acc[s][f][c]);
            };
            if (n == PLC) {
              // no test between the degrees, so that the compiler can
              // interleave their independent mode functions
#pragma unroll
              for (int k = 0; k < PLC / SPARTS; ++k) consume(SPARTS * k + part);
            } else {  // the last, partial chunk
              for (int i = part; i < n; i += SPARTS) consume(i);
            }
          }
        }
      }
      __syncthreads();
    }
    // the parts of each ring meet; part 0 writes the ring's outputs
#pragma unroll
    for (int s = 0; s < SSLOTS; ++s) {
      if (!slive[s]) continue;  // warp-uniform: the shuffles see every lane
      const int tt = t0 + (cw + s * (SCONS / 32)) * SRPW + r;
#pragma unroll
      for (int f = 0; f < NFUN; ++f)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          double v = acc[s][f][c];
#pragma unroll
          for (int o = SPARTS / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (part == 0 && tt < nt) orow[f * fstride + c * plane + tt] = v;
        }
    }
  }
}

#define KERNEL_ARGS(T)                                                         \
  static_cast<const T*>(ab), static_cast<const T*>(lt),                          \
      static_cast<const T*>(cth), static_cast<const T*>(ctl),                    \
      static_cast<const T*>(rows), static_cast<const T*>(sv),                    \
      static_cast<const int*>(sl)

// K2 / K4 (bulk_analysis_kernel) in T: the grid of partial planes, with the
// instantiation that carries a stop table and a state only where the launch
// gives them (float only).
template <typename T, int C, bool SYM>
int launch_bulk(const void* F, const void* ab, const void* lt, const void* cth,
                const void* ctl, const void* rows, const void* sv, const void* sl, void* part,
                int nl, int nm, int nt, int nplanes, int spin, int mfirst, const void* lstop,
                void* state, cudaStream_t st) {
  constexpr int R = bulk_rings<T, C, SYM>();
  constexpr int LPR = anal_lanes(R), TW = LPR * R;
  const int ntiles = (nt + TX - 1) / TX;  // the host's tiles, which it sizes the planes by
  const dim3 block(MY * LPR), grid(nplanes, (nm + MY - 1) / MY);
  if (ntiles == 0 || grid.y == 0 || nl == 0) return 0;
  if (nplanes < 1 || nplanes > ntiles || mfirst < 0) return (int)cudaErrorInvalidValue;
  // a state is handed over only at stop degrees, and only by the full form
  if (state != nullptr && (SYM || lstop == nullptr)) return (int)cudaErrorInvalidValue;
  if (SYM && lstop != nullptr) return (int)cudaErrorInvalidValue;
  const int nbt = (nt + TW - 1) / TW;     // the kernel's tiles
  const T* f = static_cast<const T*>(F);
  T* p = static_cast<T*>(part);
  const int* dd = static_cast<const int*>(lstop);
  T* ss = static_cast<T*>(state);
  if constexpr (!HAS_LO<T>) {  // float64: no stop degrees, no state
    if (lstop != nullptr) return (int)cudaErrorInvalidValue;
    bulk_analysis_kernel_f64<C, SYM, R><<<grid, block, 0, st>>>(f, KERNEL_ARGS(T), p, nl, nm, nt,
                                                                 nbt, spin, mfirst);
  } else if constexpr (SYM) {
    bulk_analysis_kernel<C, true, R, false, false><<<grid, block, 0, st>>>(
        f, KERNEL_ARGS(T), p, nl, nm, nt, nbt, spin, mfirst, nullptr, nullptr);
  } else if (lstop == nullptr) {
    bulk_analysis_kernel<C, false, R, false, false><<<grid, block, 0, st>>>(
        f, KERNEL_ARGS(T), p, nl, nm, nt, nbt, spin, mfirst, nullptr, nullptr);
  } else if (state == nullptr) {
    bulk_analysis_kernel<C, false, R, true, false><<<grid, block, 0, st>>>(
        f, KERNEL_ARGS(T), p, nl, nm, nt, nbt, spin, mfirst, dd, nullptr);
  } else {
    bulk_analysis_kernel<C, false, R, true, true><<<grid, block, 0, st>>>(
        f, KERNEL_ARGS(T), p, nl, nm, nt, nbt, spin, mfirst, dd, ss);
  }
  return (int)cudaGetLastError();
}

// K1 / K3 (bulk_synthesis_kernel) in T: one block per tile of the stop
// table, with the instantiation that carries a stop table and a state only
// where the launch gives them (float only).
template <typename T, int C, bool SYM>
int launch_bulk_synthesis(const void* A, const void* ab, const void* lt, const void* cth,
                          const void* ctl, const void* rows, const void* sv, const void* sl,
                          void* out, int nl, int nm, int nt, int spin, int mfirst,
                          const void* lstop, void* state, cudaStream_t st) {
  constexpr int R = synth_rings<T, C>();
  const dim3 block(MY * TX / R), grid((nt + TX - 1) / TX, (nm + MY - 1) / MY);
  if (grid.x == 0 || grid.y == 0 || nl == 0) return 0;
  if (mfirst < 0) return (int)cudaErrorInvalidValue;
  // a state is handed over only at stop degrees, and only by the full form
  if (state != nullptr && (SYM || lstop == nullptr)) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  T* o = static_cast<T*>(out);
  const int* dd = static_cast<const int*>(lstop);
  T* ss = static_cast<T*>(state);
  if constexpr (!HAS_LO<T>) {  // float64: no stop degrees, no state
    if (lstop != nullptr) return (int)cudaErrorInvalidValue;
    bulk_synthesis_kernel_f64<C, SYM, R><<<grid, block, 0, st>>>(a, KERNEL_ARGS(T), o, nl, nm, nt,
                                                                  spin, mfirst);
  } else if (lstop == nullptr) {
    bulk_synthesis_kernel<C, SYM, R, false, false><<<grid, block, 0, st>>>(
        a, KERNEL_ARGS(T), o, nl, nm, nt, spin, mfirst, nullptr, nullptr);
  } else if (state == nullptr) {
    bulk_synthesis_kernel<C, SYM, R, true, false><<<grid, block, 0, st>>>(
        a, KERNEL_ARGS(T), o, nl, nm, nt, spin, mfirst, dd, nullptr);
  } else if constexpr (!SYM) {
    bulk_synthesis_kernel<C, false, R, true, true><<<grid, block, 0, st>>>(
        a, KERNEL_ARGS(T), o, nl, nm, nt, spin, mfirst, dd, ss);
  }
  return (int)cudaGetLastError();
}

template <int C>
int launch_polar(const void* F, const void* ab, const void* lt, const void* cth,
                 const void* rows, const void* sv, const void* sl, void* out, int ldo,
                 int nl, int nm, int nt, int spin, int mfirst, cudaStream_t st) {
  if (nm == 0 || nl == 0) return 0;
  if (ldo < C || mfirst < 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(PolarSmem<C>);
  cudaError_t e = cudaFuncSetAttribute(polar_analysis_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  polar_analysis_kernel<C><<<nm, PTHREADS, smem, st>>>(
      static_cast<const double*>(F), static_cast<const double*>(ab),
      static_cast<const double*>(lt), static_cast<const double*>(cth),
      static_cast<const double*>(rows), static_cast<const double*>(sv),
      static_cast<const int*>(sl), static_cast<double*>(out), ldo, nl, nm, nt, spin, mfirst);
  return (int)cudaGetLastError();
}

template <int C>
int launch_polar_synthesis(const void* A, const void* ab, const void* lt, const void* cth,
                           const void* rows, const void* sv, const void* sl, void* out,
                           int lda, int ldo, int nl, int nm, int nt, int spin, int mfirst,
                           cudaStream_t st) {
  if (nm == 0 || nt == 0) return 0;  // no output entry to write
  if (lda < C || ldo < C || mfirst < 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(PolarSynthSmem<C>);
  cudaError_t e = cudaFuncSetAttribute(polar_synthesis_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  polar_synthesis_kernel<C><<<nm, STHREADS, smem, st>>>(
      static_cast<const double*>(A), static_cast<const double*>(ab),
      static_cast<const double*>(lt), static_cast<const double*>(cth),
      static_cast<const double*>(rows), static_cast<const double*>(sv),
      static_cast<const int*>(sl), static_cast<double*>(out), lda, ldo, nl, nm, nt, spin, mfirst);
  return (int)cudaGetLastError();
}

}  // namespace

// K2 / K4 (bulk_analysis_kernel) in T: C (2 or 4) is the coefficient
// count: a block's columns are (re, im) pairs, so C is always even. spin is
// read in wigner mode only; mfirst, the last argument, is the true m of row
// 0 (0 for the whole transform, the block's first m for an m block, whose
// tables ab and seeds are the block's rows); lstop is the table of stop degrees (int [m
// blocks, ring tiles of TX], 0 = skip) or null, state the handoff buffer
// [3, nm, nt] or null: the half-sky form takes neither, the full form a
// state only with stop degrees, float64 neither. The entry points are named
// pt_<kernel>_<mode>.
#define BULK_ENTRY(NAME, T, SYM)                                                   \
  extern "C" int PT_ENTRY(NAME)(int C, const void* F, const void* ab, const void* lt, \
                                const void* cth, const void* ctl, const void* rows,   \
                                const void* sv, const void* sl, void* part, int nl,   \
                                int nm, int nt, int nplanes, int spin,                \
                                const void* lstop, void* state, void* stream,         \
                                int mfirst) {                                         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                              \
    switch (C) {                                                                      \
      case 2:                                                                         \
        return launch_bulk<T, 2, SYM>(F, ab, lt, cth, ctl, rows, sv, sl, part, nl, nm, \
                                      nt, nplanes, spin, mfirst, lstop, state, st);   \
      case 4:                                                                         \
        return launch_bulk<T, 4, SYM>(F, ab, lt, cth, ctl, rows, sv, sl, part, nl, nm, \
                                      nt, nplanes, spin, mfirst, lstop, state, st);   \
      default:                                                                        \
        return (int)cudaErrorInvalidValue;                                            \
    }                                                                                 \
  }

// K1 / K3 (bulk_synthesis_kernel) in T: C is 2 or 4; in float both forms
// take stop degrees, the full form a state with them; float64 neither;
// mfirst as in BULK_ENTRY.
#define BULK_SYNTH_ENTRY(NAME, T, SYM)                                                \
  extern "C" int PT_ENTRY(NAME)(int C, const void* A, const void* ab, const void* lt, \
                                const void* cth, const void* ctl, const void* rows,   \
                                const void* sv, const void* sl, void* out, int nl,    \
                                int nm, int nt, int spin, const void* lstop,          \
                                void* state, void* stream, int mfirst) {              \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                              \
    switch (C) {                                                                      \
      case 2:                                                                         \
        return launch_bulk_synthesis<T, 2, SYM>(A, ab, lt, cth, ctl, rows, sv, sl, out,  \
                                                nl, nm, nt, spin, mfirst, lstop, state, \
                                                st);                                  \
      case 4:                                                                         \
        return launch_bulk_synthesis<T, 4, SYM>(A, ab, lt, cth, ctl, rows, sv, sl, out,  \
                                                nl, nm, nt, spin, mfirst, lstop, state, \
                                                st);                                  \
      default:                                                                        \
        return (int)cudaErrorInvalidValue;                                            \
    }                                                                                 \
  }

#if LEGENDRE_MODE != 4  // the wigner mode has no half-sky kernels
BULK_ENTRY(pt_sym_bulk_analysis, float, true)
BULK_SYNTH_ENTRY(pt_sym_bulk_synthesis, float, true)
BULK_ENTRY(pt_sym_bulk_analysis_f64, double, true)
BULK_SYNTH_ENTRY(pt_sym_bulk_synthesis_f64, double, true)
#endif
BULK_ENTRY(pt_full_bulk_analysis, float, false)
BULK_SYNTH_ENTRY(pt_full_bulk_synthesis, float, false)
BULK_ENTRY(pt_full_bulk_analysis_f64, double, false)
BULK_SYNTH_ENTRY(pt_full_bulk_synthesis_f64, double, false)

// K4's float64 near-pole pass (polar_analysis_kernel), every mode: C (2 or 4)
// columns of F [NFUN, C, nm, nt], written at column stride ldo into out
// [nl, nm, ldo]; no stop degrees, no state, and no low part of cos theta
// (zero in float64); mfirst as in BULK_ENTRY.
extern "C" int PT_ENTRY(pt_polar_analysis)(int C, const void* F, const void* ab,
                                           const void* lt, const void* cth,
                                           const void* rows, const void* sv,
                                           const void* sl, void* out, int ldo, int nl,
                                           int nm, int nt, int spin, void* stream,
                                           int mfirst) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 2:
      return launch_polar<2>(F, ab, lt, cth, rows, sv, sl, out, ldo, nl, nm, nt, spin, mfirst,
                             st);
    case 4:
      return launch_polar<4>(F, ab, lt, cth, rows, sv, sl, out, ldo, nl, nm, nt, spin, mfirst,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3's float64 near-pole pass (polar_synthesis_kernel), every mode: C (2 or
// 4) columns of A [nl, nm, lda] (from its pointer on, at column stride lda)
// into out [NFUN, ldo, nm, nt] (from its pointer on: the columns of a launch
// start there), every entry of those C columns written; no stop degrees, no
// state, and no low part of cos theta; mfirst as in BULK_ENTRY.
extern "C" int PT_ENTRY(pt_polar_synthesis)(int C, const void* A, const void* ab,
                                            const void* lt, const void* cth,
                                            const void* rows, const void* sv,
                                            const void* sl, void* out, int lda, int ldo,
                                            int nl, int nm, int nt, int spin, void* stream,
                                            int mfirst) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 2:
      return launch_polar_synthesis<2>(A, ab, lt, cth, rows, sv, sl, out, lda, ldo, nl, nm, nt,
                                       spin, mfirst, st);
    case 4:
      return launch_polar_synthesis<4>(A, ab, lt, cth, rows, sv, sl, out, lda, ldo, nl, nm, nt,
                                       spin, mfirst, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel tile sizes, so the host can size the partial planes and the
// dead-tile table.
extern "C" int PT_ENTRY(pt_tile_theta)() { return TX; }
extern "C" int PT_ENTRY(pt_tile_m)() { return MY; }

