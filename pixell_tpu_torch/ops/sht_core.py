"""Plain PyTorch scaled Legendre recurrence: the twin of every Legendre kernel.

Counterpart of pixell_tpu/ops/sht_core.py (the Legendre modes and the
Wigner-d engine for spin > 2). The normalized associated Legendre
values lambda_lm(theta) are carried for all (m, theta) at once through the
three-term l-recurrence in a scaled representation
lambda = val * 2^(S*level), S = 850 (f64) / 60 (f32), so that
lambda_mm ~ sin^m(theta) cannot underflow near the poles. Only levels 0 and
-1 can contribute above 2^-S, so unscaling is a three-way select.

Modes (pixell_tpu.ops.sht_core.MODES): "scalar" emits u_0 = lambda;
"deriv" [lambda, d lambda/d theta]; "spin1" [w1, x1]; "spin2" [w2, x2],
the theta-functions of spin-weighted harmonics, closed forms of
(lambda_l, lambda_{l-1}) (see mode_funcs); "wigner" [w_s, x_s] for any
spin s from the two Wigner-d branches (see wigner_values), on a geometry
prepared with that s. Engine contract, nfun = NFUN[mode]:
  synthesis_scan(A[nl,nm,C], theta[nt]) -> G[nfun,C,nm,nt],
      G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c]
  analysis_scan(F[nfun,C,nm,nt], theta[nt]) -> A[nl,nm,C],
      A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t]

This module is what the SHT runs on CPU tensors, and what every CUDA kernel
in csrc/legendre.cu and csrc/blockleg.cu is held against on the card. It is
written for clarity: a Python loop over l with whole-[nm, nt] tensor
operations. The block-Legendre split's plain versions (blk_synthesis,
blk_analysis) are at the end.
"""
from __future__ import annotations
import numpy as np
import torch

LBLOCK = 8  # the state is renormalized after every LBLOCK l-steps (l % 8 == 7)

MODES = {"scalar": 0, "deriv": 1, "spin1": 2, "spin2": 3, "wigner": 4}
NFUN = {"scalar": 1, "deriv": 2, "spin1": 2, "spin2": 2, "wigner": 2}
# Parity of each mode function under theta -> pi - theta
# (pixell_tpu/ops/sht_pallas.py:61): u_f(pi - theta) = PSIGN[f] (-1)^(l+m) u_f(theta).
# The Wigner mode has no half-sky form, as in the reference.
PSIGN = {"scalar": (1,), "deriv": (1, -1), "spin1": (-1, 1), "spin2": (1, -1)}


def scale_log2(dtype):
	"""Scaled-representation chunk S (pixell_tpu.ops.sht_core._scale_log2):
	2^850 for f64, 2^60 for f32, leaving headroom below overflow for the
	growth between two renormalizations."""
	return 850 if dtype == torch.float64 else 60


def _np_dtype(dtype):
	return np.float64 if dtype == torch.float64 else np.float32


def check_mode(mode):
	if mode not in MODES:
		raise ValueError("unknown Legendre mode '%s'" % mode)


class Geom:
	"""Per-ring tables of the recurrence, all on one device:
	ct/ct_lo [nt] (two-part cos theta; ct_lo is zero in f64),
	seed_val [nm, nt] and seed_level [nm, nt] int32, the scaled lambda_mm,
	and rows [4, nt], the rows the spin/derivative modes need: ct_st =
	cos/sin, inv_st = 1/sin, inv_st2 = 1/sin^2 (all zero on a pole ring)
	and notpole (0 on a pole ring, else 1). A geometry prepared for the
	Wigner mode has s, the spin, and seeds [2, nm, nt]: the +s and -s
	branches at l = max(m, s) (wigner_seeds); else s is None."""
	def __init__(self, ct, ct_lo, seed_val, seed_level, rows, s=None):
		self.ct, self.ct_lo = ct, ct_lo
		self.seed_val, self.seed_level = seed_val, seed_level
		self.rows = rows
		self.ct_st, self.inv_st, self.inv_st2, self.notpole = rows
		self.s = s
	@property
	def dtype(self): return self.ct.dtype
	@property
	def nm(self): return self.seed_val.shape[-2]
	@property
	def nt(self): return self.seed_val.shape[-1]


def _sin_theta(theta, dtype):
	"""(sin theta clamped to >= 0, pole mask) in float64. Pole detection
	covers the input dtype's rounding of theta: in f32, sin(fl32(pi)) =
	-8.7e-8 -- a ring that close to a pole is AT it
	(pixell_tpu.ops.sht_core._prepare_geom :115)."""
	th = np.asarray(theta, np.float64)
	eps_pole = 1e-12 if dtype == torch.float64 else 1e-6
	st = np.sin(th)
	pole = np.abs(st) < eps_pole
	return np.where(pole, 0.0, np.maximum(st, 0.0)), pole


def scaled_seeds(theta, mmax, dtype):
	"""Seeds lambda_mm(theta) = (-1)^m sqrt((2m+1)/4pi) prod_{k<=m} sin(theta)
	sqrt((2k-1)/2k) as (val [nm, nt], level [nm, nt] int32) numpy arrays with
	S = scale_log2(dtype).

	Counterpart of the seed half of pixell_tpu.ops.sht_core._prepare_geom
	(:100) and its _scaled_cumprod (:76): a running product over m with an
	exact power-of-two renormalization, so every operation is a plain
	multiply. The product is taken in float64 on the host and the value
	rounded once to dtype; the exponent form exp2(m log2 sin theta) would
	cost about three digits in float32."""
	S = scale_log2(dtype)
	band, invband = 2.0**S, 2.0**-S
	st, _ = _sin_theta(theta, dtype)
	nm, nt = mmax + 1, st.shape[0]
	vals = np.empty((nm, nt)); levs = np.empty((nm, nt), np.int32)
	val = np.ones(nt); lev = np.zeros(nt, np.int32)
	vals[0] = val; levs[0] = lev
	for m in range(1, nm):
		val = val*(st*np.sqrt((2*m - 1)/(2*m)))
		# |val|: negative rounding noise must not loop the renormalizer
		small = np.abs(val) < invband
		val = np.where(small, val*band, val)
		lev = lev - small.astype(np.int32)
		vals[m] = val; levs[m] = lev
	m = np.arange(nm)
	pref = np.sqrt((2*m + 1)/(4*np.pi))*np.where(m % 2 == 0, 1.0, -1.0)
	return (vals*pref[:, None]).astype(_np_dtype(dtype)), levs


def ct_parts(theta, dtype):
	"""Two-part cos(theta) from float64 theta (pixell_tpu/ops/sht_pallas.py
	_ct_parts :454 and sht_core.py:128): in f32 a plain cos has ~3e-8
	ABSOLUTE error near the poles, which the recurrence amplifies by
	~l^2/2, so the f64 remainder is carried as a separate low part. In f64
	the low part is zero."""
	ct64 = np.cos(np.asarray(theta, np.float64))
	ct = ct64.astype(_np_dtype(dtype))
	lo = (ct64 - ct.astype(np.float64)).astype(ct.dtype) if dtype == torch.float32 \
		else np.zeros_like(ct)
	return ct, lo


def mode_rows(theta, dtype):
	"""(ct_st, inv_st, inv_st2, notpole) numpy rows from float64 host sin and
	cos, rounded once to dtype (pixell_tpu.ops.sht_core._prepare_geom
	:116-133). The 1/sin factors are zeroed on pole rings, whose limits the
	mode functions add separately."""
	st, pole = _sin_theta(theta, dtype)
	ct64 = np.cos(np.asarray(theta, np.float64))
	st_safe = np.where(pole, 1.0, st)
	rows = (ct64/st_safe, np.where(pole, 0.0, 1/st_safe),
		np.where(pole, 0.0, 1/(st_safe*st_safe)), np.where(pole, 0.0, 1.0))
	return tuple(r.astype(_np_dtype(dtype)) for r in rows)


def prepare_geom(theta, mmax, dtype, device=None, s=None):
	"""Recurrence tables for concrete float64 ring colatitudes theta
	(pixell_tpu.ops.sht_core._prepare_geom :100), built on the host and
	moved to device. With s, the seeds are the Wigner mode's for spin s."""
	if dtype not in (torch.float32, torch.float64):
		raise TypeError("Legendre recurrence dtype must be float32 or float64")
	ct, lo = ct_parts(theta, dtype)
	sv, sl = scaled_seeds(theta, mmax, dtype) if s is None else \
		wigner_seeds(theta, mmax, s, dtype)
	f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
	return Geom(f(ct), f(lo), f(sv), f(sl), f(np.stack(mode_rows(theta, dtype))), s)


def recur_ab(l, marr):
	"""Recurrence coefficients a_lm, b_lm for degree l (a Python int or a
	tensor of degrees broadcasting against marr) and the m values marr, in
	marr's dtype (pixell_tpu/ops/sht_core.py:262-265):
	lambda_l = a ((cos theta) lambda_{l-1} - b lambda_{l-2}). Differences
	are FACTORED ((l-m)(l+m)) to dodge the l^2 - m^2 cancellation; the
	clamps keep rows with l < m finite and their state exactly 0."""
	lf = torch.as_tensor(l, dtype=marr.dtype, device=marr.device)
	a = torch.sqrt(torch.clamp((2*lf - 1)*(2*lf + 1), min=0.0)
		/ torch.clamp((lf - marr)*(lf + marr), min=0.25))
	b = torch.sqrt(torch.clamp((lf - 1 - marr)*(lf - 1 + marr), min=0.0)
		/ torch.clamp((2*lf - 3)*(2*lf - 1), min=1.0))
	return a, b


def recur_e(l, marr):
	"""e_lm = sqrt((l^2 - m^2)(2l+1)/(2l-1)) of the mode functions, in marr's
	dtype, zero for l < m (pixell_tpu/ops/sht_core.py:174). The difference
	is FACTORED as (l-m)(l+m): the reference's f32 l*l - m*m is exact only
	while l*l < 2^24, so the two give identical numbers up to l = 4096 and
	the factored form stays within one rounding above it."""
	lf = torch.as_tensor(l, dtype=marr.dtype, device=marr.device)
	return torch.sqrt(torch.clamp((lf - marr)*(lf + marr)*(2*lf + 1), min=0.0)
		/ torch.clamp(2*lf - 1, min=1.0))


def l_norms(mode, l):
	"""Per-degree factors (nrm, hp) of the mode functions for the degrees l
	(a float tensor): nrm is sqrt(l(l+1)) for deriv, 1/sqrt(l(l+1)) for
	spin1 and 1/sqrt((l-1)l(l+1)(l+2)) for spin2, each clamped as in
	pixell_tpu/ops/sht_core.py:189-206; hp = sqrt((2l+1)/4pi)/2 weighs the
	pole-row limits."""
	if mode == "deriv":
		nrm = torch.sqrt(torch.clamp(l*(l + 1), min=0.0))
	elif mode == "spin1":
		nrm = 1/torch.sqrt(torch.clamp(l*(l + 1), min=1.0))
	else:
		nrm = 1/torch.sqrt(torch.clamp((l - 1)*l*(l + 1)*(l + 2), min=1.0))
	return nrm, torch.sqrt((2*l + 1)/(4*np.pi))/2


def mode_funcs(mode, l, marr, g, lam, lam1):
	"""Mode functions u_f(l, m, theta) as [nm, nt] tensors from the true
	lambda_l (lam) and lambda_{l-1} (lam1) (pixell_tpu.ops.sht_core.
	_funcs_at_l :168):
	  deriv: [lam, dlam],  dlam = (l cos lam - e lam1)/sin
	  spin1: w1 = -N1 dlam,  x1 = N1 (m/sin) lam
	  spin2: w2 = N2 (-(2(l - m^2)/sin^2 + l(l-1)) lam + 2 e cos/sin^2 lam1)
	         x2 = 2 N2 (m/sin^2) (-(l-1) cos lam + e lam1)
	The 1/sin terms are zeroed on pole rings and replaced by their limits,
	which are nonzero only at m = 1 (deriv, spin1) and m = 2 (spin2)."""
	if mode == "scalar": return [lam]
	dt, dev = lam.dtype, lam.device
	lf = torch.tensor(float(l), dtype=dt, device=dev)
	e = recur_e(lf, marr)[:, None]
	nrm, hp = l_norms(mode, lf)
	ct, cts, ist, ist2, npole = g.ct, g.ct_st, g.inv_st, g.inv_st2, g.notpole
	north = (1 - npole)*(ct > 0)
	south = (1 - npole)*(ct < 0)
	sgl = 1.0 if l % 2 == 0 else -1.0
	msel = (marr == (2 if mode == "spin2" else 1))[:, None]
	zero = torch.zeros((), dtype=dt, device=dev)
	if mode == "deriv":
		dlam = (lf*cts*lam - e*ist*lam1)*npole
		if l >= 1:
			dlam = dlam + torch.where(msel, -nrm*hp*(north + sgl*south), zero)
		return [lam, dlam]
	if l < (1 if mode == "spin1" else 2):
		return [torch.zeros_like(lam), torch.zeros_like(lam)]
	wp = torch.where(msel, hp*(north + sgl*south), zero)
	xp = torch.where(msel, hp*(-north + sgl*south), zero)
	mcol = marr[:, None]
	if mode == "spin1":
		w = -nrm*(lf*cts*lam - e*ist*lam1)*npole
		x = nrm*mcol*ist*lam*npole
	else:
		# l - m^2 in integers, rounded once (exact in f32 while m^2 < 2^24)
		lmm = (l - torch.arange(marr.shape[0], device=dev)**2).to(dt)[:, None]
		w = nrm*(-(2*lmm*ist2 + lf*(lf - 1))*lam + 2*e*ct*ist2*lam1)*npole
		x = 2*nrm*mcol*ist2*(-(lf - 1)*ct*lam + e*lam1)*npole
	return [w + wp, x + xp]


def lambdas(g, lmax, stop=None, state=None):
	"""The scaled recurrence over l = 0..lmax (pixell_tpu.ops.sht_core.
	_scan_core :221): yields (l, lambda_l, lambda_{l-1}), the true
	(unscaled) values as [nm, nt] tensors. With stop [nm, nt] (integer stop
	degrees) and state [3, nm, nt] (zeros), the scaled state (prev, curr,
	level) of each entry is written into state as it stands after degree
	min(stop, lmax + 1) - 1, renormalization included: the handoff to the
	block-Legendre kernels (pixell_tpu.ops.sht_pallas dump_state :1546)."""
	dt, dev = g.dtype, g.ct.device
	nm, nt = g.nm, g.nt
	S = scale_log2(dt)
	band, invband = 2.0**S, 2.0**-S
	marr = torch.arange(nm, dtype=dt, device=dev)
	one = torch.ones((), dtype=dt, device=dev)
	fac_m1, zero = one*invband, one*0
	x, xlo = g.ct[None, :], g.ct_lo[None, :]
	prev = torch.zeros((nm, nt), dtype=dt, device=dev)
	curr = torch.zeros_like(prev)
	lev = torch.zeros((nm, nt), dtype=torch.int32, device=dev)
	def dump(sel):
		for i, v in enumerate((prev, curr, lev.to(dt))):
			state[i] = torch.where(sel, v, state[i])
	stops = set() if state is None else set(torch.unique(stop).tolist())
	for l in range(lmax + 1):
		a, b = recur_ab(l, marr)
		new = a[:, None]*((x*curr + xlo*curr) - b[:, None]*prev)
		if l < nm:
			# seed row m = l; the stale previous value there has another scale
			new[l] = g.seed_val[l]
			lev[l] = g.seed_level[l]
			curr[l] = 0
		# unscale: only levels 0 and -1 can contribute
		fac = torch.where(lev == 0, one, torch.where(lev == -1, fac_m1, zero))
		yield l, new*fac, curr*fac
		prev, curr = curr, new
		if l % LBLOCK == LBLOCK - 1:
			big = torch.abs(curr) > band
			prev = torch.where(big, prev*invband, prev)
			curr = torch.where(big, curr*invband, curr)
			lev = lev + big.to(torch.int32)
		if l + 1 in stops and l < lmax: dump(stop == l + 1)
	if state is not None: dump(stop > lmax)


# ---------------------------------------------------------------------------
# General spin (|s| > 2) through the Wigner-d recurrence
# (pixell_tpu/ops/sht_core.py:326-525). sYlm = (w + x) e^{i m phi} with
#   w = (lam_p + (-1)^s lam_m)/2,  x = (lam_p - (-1)^s lam_m)/2,
# lam_p = (-1)^m sqrt((2l+1)/4pi) d^l_{-m,s}(theta) and lam_m its s -> -s
# partner. Both branches obey
#   v_l lam_l = (cos theta +- m s/((l-1) l)) lam_{l-1} - v_{l-1} lam_{l-2},
#   v_l = sqrt((l-m)(l+m)(l-s)(l+s)) / (l sqrt(4 l^2 - 1)),
# seeded at l0 = max(m, s). There is no 1/sin(theta): poles need no mask.
# ---------------------------------------------------------------------------
def scaled_pow_table(base, nmax):
	"""base^k for k = 0..nmax as (mantissa [nmax+1, nt] float64, in
	[0.5, 1) or 0, exponent [nmax+1, nt] int64): a running product
	renormalized by an exact power of two at every step, so it can neither
	underflow nor lose digits (pixell_tpu.ops.sht_core._scaled_pow_table
	:344). base [nt] float64 in [0, 1]; 0^0 = 1."""
	nt = base.shape[0]
	bm, be = np.frexp(base)
	mant = np.empty((nmax + 1, nt)); expo = np.empty((nmax + 1, nt), np.int64)
	m, e = np.full(nt, 0.5), np.ones(nt, np.int64)
	for k in range(nmax + 1):
		mant[k] = m; expo[k] = e
		m, de = np.frexp(m*bm)
		e = e + be + de
	return mant, expo


def wigner_seed_norms(mmax, s):
	"""(log2 N [nm], sign_p [nm], sign_m [nm]) with
	N = sqrt((2 l0 + 1)/4pi (2 l0)!/((m+s)! |m-s|!)), l0 = max(m, s), from
	lgamma on the host; sign_p is the (-1)^m convention sign, sign_m that
	times the (-1)^(s-m) of the -s branch for m < s
	(pixell_tpu.ops.sht_core._wigner_seed_norms :353)."""
	from math import lgamma
	m = np.arange(mmax + 1)
	l0 = np.maximum(m, s)
	ln = np.array([0.5*(lgamma(2*L + 1) - lgamma(mm + s + 1) - lgamma(abs(mm - s) + 1))
		for L, mm in zip(l0, m)])
	log2n = (ln + 0.5*np.log((2*l0 + 1)/(4*np.pi)))/np.log(2.0)
	sign_p = np.where(m % 2 == 0, 1.0, -1.0)
	sign_m = sign_p*np.where((m < s) & ((s - m) % 2 == 1), -1.0, 1.0)
	return log2n, sign_p, sign_m


def wigner_seeds(theta, mmax, s, dtype):
	"""Seeds of the +s and -s branches at l0 = max(m, s) as (val [2, nm, nt]
	in dtype, level [2, nm, nt] int32) numpy arrays with S =
	scale_log2(dtype): N[m] sin(theta/2)^a cos(theta/2)^b with (a, b) =
	(m+s, |m-s|) for +s and swapped for -s
	(pixell_tpu.ops.sht_core._wigner_seeds :371).

	Each factor is held as mantissa times a power of two in float64 on the
	host, the exponents are added as integers, and the value is rounded once
	to dtype. The level is the smallest that keeps |val| < 1, but never
	above 0: the recurrence emits only from levels 0 and -1, so an O(1) seed
	stored as (2^-S, level +1), which log2 N > S invites for m > ~61 in
	float32, would be dropped. On a pole ring (_sin_theta) sin(theta/2) or
	cos(theta/2) is exactly 0, so its seed is 0 wherever its exponent is not."""
	S = scale_log2(dtype)
	th = np.asarray(theta, np.float64)
	_, pole = _sin_theta(th, dtype)
	sb = np.where(pole & (th < 1), 0.0, np.maximum(np.sin(th/2), 0.0))
	cb = np.where(pole & (th > 1), 0.0, np.maximum(np.cos(th/2), 0.0))
	pm, pe = scaled_pow_table(sb, mmax + s)
	qm, qe = scaled_pow_table(cb, mmax + s)
	log2n, sign_p, sign_m = wigner_seed_norms(mmax, s)
	ne = np.floor(log2n).astype(np.int64)
	nv = np.exp2(log2n - ne)
	m = np.arange(mmax + 1)
	a, b = m + s, np.abs(m - s)
	vals, levs = [], []
	for sign, ea, eb in ((sign_p, a, b), (sign_m, b, a)):
		mant, de = np.frexp((sign*nv)[:, None]*pm[ea]*qm[eb])
		expo = ne[:, None] + pe[ea] + qe[eb] + de
		lev = np.minimum(-(-expo//S), 0)
		lev = np.where(mant == 0, 0, lev)
		vals.append(np.ldexp(mant, np.where(mant == 0, 0, expo - S*lev).astype(np.int32)))
		levs.append(lev.astype(np.int32))
	return np.stack(vals).astype(_np_dtype(dtype)), np.stack(levs)


def wigner_abc(l, marr, s):
	"""Coefficients (a, b, c) of the Wigner-d recurrence at degree l (a
	Python int or a tensor broadcasting against marr) for the m values marr
	and spin s, in marr's dtype:
	lam_l = a ((cos theta +- c) lam_{l-1} - b lam_{l-2}), a = 1/v(l),
	b = v(l-1), c = m s/((l-1) l), all zero for l <= max(m, s), where the
	seed sets the state (pixell_tpu.ops.sht_pallas._wigner_ab_tables :108).
	Differences are factored, as in recur_ab."""
	lf = torch.as_tensor(l, dtype=marr.dtype, device=marr.device)
	sf = float(s)
	def v(lv):
		num = torch.clamp((lv - marr)*(lv + marr)*(lv - sf)*(lv + sf), min=0.0)
		den = torch.clamp(lv*torch.sqrt(torch.clamp(4*lv*lv - 1, min=0.0)), min=1.0)
		return torch.sqrt(num)/den
	vl = v(lf)
	zero = torch.zeros((), dtype=marr.dtype, device=marr.device)
	a = torch.where(vl > 0, 1/torch.clamp(vl, min=1e-30), zero)
	c = marr*sf/torch.clamp((lf - 1)*lf, min=1.0)
	live = lf > torch.clamp(marr, min=sf)
	return tuple(torch.where(live, t, zero) for t in (a, v(lf - 1), c))


def wigner_values(g, lmax):
	"""The two-branch scaled Wigner-d recurrence over l = 0..lmax on a
	geometry prepared with spin g.s (pixell_tpu.ops.sht_core.
	_wigner_scan_core :422): yields (l, [w, x]), the true mode functions as
	[nm, nt] tensors. The coefficients are computed in float64 and rounded
	once to the working dtype, as the kernels' tables are."""
	dt, dev = g.dtype, g.ct.device
	nm, nt, s = g.nm, g.nt, int(g.s)
	S = scale_log2(dt)
	band, invband = 2.0**S, 2.0**-S
	marr = torch.arange(nm, dtype=torch.float64, device=dev)
	seed_at = torch.clamp(torch.arange(nm, device=dev), min=s)[None, :, None]
	one = torch.ones((), dtype=dt, device=dev)
	fac_m1, zero = one*invband, one*0
	sgs = -1.0 if s % 2 else 1.0
	sgn = torch.tensor([1.0, -1.0], dtype=dt, device=dev)[:, None, None]
	x, xlo = g.ct[None, None, :], g.ct_lo[None, None, :]
	prev = torch.zeros((2, nm, nt), dtype=dt, device=dev)
	curr = torch.zeros_like(prev)
	lev = torch.zeros((2, nm, nt), dtype=torch.int32, device=dev)
	for l in range(lmax + 1):
		a, b, c = (t.to(dt)[None, :, None] for t in wigner_abc(l, marr, s))
		new = a*((x*curr + xlo*curr + (sgn*c)*curr) - b*prev)
		seed = seed_at == l
		new = torch.where(seed, g.seed_val, new)
		lev = torch.where(seed, g.seed_level, lev)
		curr = torch.where(seed, zero, curr)
		fac = torch.where(lev == 0, one, torch.where(lev == -1, fac_m1, zero))
		lam = new*fac
		yield l, [0.5*(lam[0] + sgs*lam[1]), 0.5*(lam[0] - sgs*lam[1])]
		prev, curr = curr, new
		if l % LBLOCK == LBLOCK - 1:
			big = torch.abs(curr) > band
			prev = torch.where(big, prev*invband, prev)
			curr = torch.where(big, curr*invband, curr)
			lev = lev + big.to(torch.int32)


def mode_values(mode, g, lmax, stop=None, state=None):
	"""Yields (l, [u_f as [nm, nt] tensors]) for l = 0..lmax in any mode;
	stop and state as in lambdas (the Legendre modes only)."""
	if (mode == "wigner") != (g.s is not None):
		raise ValueError("mode '%s' on a geometry prepared %s a spin" % (mode,
			"without" if g.s is None else "with"))
	if mode == "wigner":
		if state is not None: raise ValueError("the wigner mode hands over no state")
		yield from wigner_values(g, lmax)
		return
	marr = torch.arange(g.nm, dtype=g.dtype, device=g.ct.device)
	for l, lam, lam1 in lambdas(g, lmax, stop, state):
		yield l, mode_funcs(mode, l, marr, g, lam, lam1)


def _state_buffer(g, stop, dump_state):
	if not dump_state: return None
	if stop is None: raise ValueError("dump_state needs the stop degrees")
	return torch.zeros((3, g.nm, g.nt), dtype=g.dtype, device=g.ct.device)


def synthesis(A, g, lmax, mode="scalar", stop=None, dump_state=False):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c] on prepared geometry g:
	A [nl, nm, C] -> [nfun, C, nm, nt]. stop [nm, nt] (integers), if given,
	ends the sum of entry (m, t) before degree stop[m, t]: 0 leaves it 0 (the
	kernels' dead-tile skip), lmax + 1 or more runs it to the end. With
	dump_state, returns (G, state): the scaled recurrence state
	[3, nm, nt] (prev, curr, level) of each entry where its sum ended."""
	check_mode(mode)
	A = A.to(g.dtype)
	out = torch.zeros((NFUN[mode], A.shape[-1], g.nm, g.nt), dtype=g.dtype, device=g.ct.device)
	state = _state_buffer(g, stop, dump_state)
	for l, us in mode_values(mode, g, lmax, stop, state):
		for f, u in enumerate(us):
			if stop is not None: u = u*(stop > l)
			out[f] += u[None]*A[l].T[:, :, None]
	return (out, state) if dump_state else out

def analysis(F, g, lmax, mode="scalar", stop=None, dump_state=False):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t] on prepared
	geometry g: F [nfun, C, nm, nt] -> [nl, nm, C]. stop [nm, nt]
	(integers), if given, leaves entry (m, t) out of every degree from
	stop[m, t] on: 0 never reads it (the kernels' dead-tile skip). With
	dump_state, returns (A, state) as synthesis does."""
	check_mode(mode)
	F = F.to(g.dtype)
	out = torch.zeros((lmax + 1, g.nm, F.shape[1]), dtype=g.dtype, device=g.ct.device)
	state = _state_buffer(g, stop, dump_state)
	for l, us in mode_values(mode, g, lmax, stop, state):
		for f, u in enumerate(us):
			if stop is not None: u = u*(stop > l)
			out[l] += torch.einsum("mt,cmt->mc", u, F[f])
	return (out, state) if dump_state else out


# ---------------------------------------------------------------------------
# The block-Legendre split (pixell_tpu/ops/sht_pallas.py:556-610). Within a
# block of BLK_LB degrees that holds no seed, the scaled recurrence is linear
# in the state (curr, prev) at the block's entry,
#   P_{l0+k} = gA_k(cos theta) curr + gB_k(cos theta) prev,
# with gA_k, gB_k polynomials of degree <= k + 1 in cos theta that obey the
# recurrence themselves from (gA, gB) = (1, 0), (0, 1). They are carried as
# VALUES at the BLK_JP Chebyshev nodes of a ring tile's cos theta interval,
# where their sums against the alm (synthesis) or the ring data (analysis)
# fold, and one node -> ring product per block with the Lagrange basis W
# takes them to the tile's rings. The stepwise scan runs each tile up to its
# handoff degree and dumps its state (synthesis / analysis with stop and
# dump_state); blk_synthesis / blk_analysis resume from there. The state is
# the float32 kernels', scaled by 2^(BLK_S level), in whatever dtype the
# twin computes.
# ---------------------------------------------------------------------------
BLK_LB = 112   # degrees per block: a multiple of LBLOCK, at most BLK_JP - 2
BLK_JP = 128   # Chebyshev nodes per ring tile
BLK_S = 60     # scale_log2 of the float32 state the block path resumes from
# Coefficient streams of each mode (_blk_mode_spec :774): 0 weighs lambda_l
# (the current chain value), 1 lambda_{l-1} (the previous one).
BLK_FAM = {"scalar": (0,), "deriv": (0, 0, 1), "spin1": (0, 1, 0), "spin2": (0, 0, 1, 0)}


class BlkTables:
	"""Per-ring-set tables of the block-Legendre kernels, all on one device:
	start [nmb, ntb] int32, the first BLK_LB-block each (m tile, ring tile)
	runs blocked (ceil(nl/BLK_LB) or more: none); ctv [ntb, BLK_JP], cos
	theta at each ring tile's nodes; W [ntb, BLK_JP, tile_t], W[n, j, t] =
	l_j(x_t), the Lagrange basis through the nodes at the tile's rings (zero
	on padding rings); and for the analysis kernel Wtf32 [2, ntb, BLK_JP,
	tile_t], W in float32 split into TF32 hi and lo (ops/sht_cuda.py
	tf32_split), or None (the plain versions do not read it)."""
	def __init__(self, start, ctv, W, tile_m, tile_t, Wtf32=None):
		self.start, self.ctv, self.W, self.Wtf32 = start, ctv, W, Wtf32
		self.tile_m, self.tile_t = int(tile_m), int(tile_t)


def blk_stream_tables(nl, nm, mode, dtype, device=None):
	"""[NS, nl, nm]: the (l, m) coefficient streams c_s of a mode, whose mode
	functions separate as u_f = sum_s c_s(l, m) x (lambda_l or lambda_{l-1})
	x a ring factor (blk_combine) (pixell_tpu.ops.sht_pallas.
	_spin2_stream_tables :723, _deriv_stream_tables :748,
	_spin1_stream_tables :760); scalar is one stream of ones. e_lm is
	factored, as recur_e."""
	l = torch.arange(nl, dtype=dtype, device=device)[:, None]
	m = torch.arange(nm, dtype=dtype, device=device)[None, :]
	ones = torch.ones((nl, nm), dtype=dtype, device=device)
	if mode == "scalar": return ones[None].clone()
	e = recur_e(l, m)
	if mode == "deriv": return torch.stack([ones, l*ones, -e])
	nrm = l_norms(mode, l)[0]
	if mode == "spin1":
		valid = (l >= 1).to(dtype)
		return torch.stack([-nrm*l*valid*ones, nrm*e*valid, nrm*valid*ones])
	if mode != "spin2": raise ValueError("no block-Legendre streams in mode '%s'" % mode)
	valid = (l >= 2).to(dtype)
	return torch.stack([-nrm*l*(l - 1)*valid*ones, -2*nrm*(l - m*m)*valid,
		2*nrm*e*valid, -2*nrm*(l - 1)*valid*ones])


def blk_combine(mode, ts, ct, cts, ist, ist2, marr):
	"""The mode functions' sums [nfun] from the interpolated stream sums
	ts[s] and the ring factors (_blk_mode_spec synth_combine :786-802)."""
	if mode == "scalar": return [ts[0]]
	if mode == "deriv": return [ts[0], cts*ts[1] + ist*ts[2]]
	if mode == "spin1": return [cts*ts[0] + ist*ts[1], marr*(ist*ts[2])]
	ctist2 = ct*ist2
	return [ts[0] + ist2*ts[1] + ctist2*ts[2], marr*(ctist2*ts[3] + ist2*ts[2])]


def blk_fields(mode, F0, F1, ct, cts, ist, ist2, marr):
	"""The ring-weighted fields [NS] the streams contract against in
	analysis, the transpose of blk_combine (_blk_mode_spec anal_fields
	:790-804). F0, F1: the data of the mode's first and last function."""
	if mode == "scalar": return [F0]
	if mode == "deriv": return [F0, cts*F1, ist*F1]
	if mode == "spin1": return [cts*F0, ist*F0, marr*(ist*F1)]
	return [F0, ist2*F0, ist2*(ct*F0 + marr*F1), (marr*ct)*(ist2*F1)]


class _BlkRun:
	"""What blk_synthesis and blk_analysis share: the padded tables and
	state, one block's node chains, and the state's step over a block."""
	def __init__(self, state, tab, g, nl, mode):
		if mode not in BLK_FAM: raise ValueError("no block-Legendre path in mode '%s'" % mode)
		self.dt, self.dev = state.dtype, state.device
		self.mode, self.fam = mode, BLK_FAM[mode]
		self.nm, self.nt, self.nl = g.nm, g.nt, nl
		self.nmb, self.ntb = tab.start.shape
		self.TM, self.TT = tab.tile_m, tab.tile_t
		self.nmp, self.ntp = self.nmb*self.TM, self.ntb*self.TT
		if self.nmp < g.nm or self.ntp < g.nt or tuple(state.shape) != (3, g.nm, g.nt):
			raise ValueError("block tables or state of another grid")
		self.nlb = -(-nl//BLK_LB)
		nlp = self.nlb*BLK_LB
		dt, dev = self.dt, self.dev
		self.W, self.ctv = tab.W.to(dt), tab.ctv.to(dt)[None]          # [ntb, JP, TT], [1, ntb, JP]
		# the first block of each (m, ring tile)
		self.start = tab.start.to(dev).repeat_interleave(self.TM, 0)[:, :, None]
		self.first = int(tab.start.min())
		# [..., nl, nm] tables zero padded to whole blocks and tiles: a = 0 ends the chains
		lm = lambda t: torch.nn.functional.pad(t, (0, self.nmp - g.nm, 0, nlp - nl))
		l = torch.arange(nl, dtype=dt, device=dev)[:, None]
		m = torch.arange(g.nm, dtype=dt, device=dev)[None, :]
		self.a, self.b = (lm(t) for t in recur_ab(l, m))
		self.cs = lm(blk_stream_tables(nl, g.nm, mode, dt, dev))         # [NS, nlp, nmp]
		self.pad_lm = lm
		prev, curr, lev = (self.tiles(t) for t in state)
		self.prev, self.curr, self.lev = prev.clone(), curr.clone(), lev.clone()
		ring = lambda r: torch.nn.functional.pad(r.to(dt), (0, self.ntp - g.nt)).view(self.ntb, self.TT)
		self.rings = (ring(g.ct), ring(g.ct_st), ring(g.inv_st), ring(g.inv_st2),
			torch.arange(self.nmp, dtype=dt, device=dev)[:, None, None])

	def tiles(self, x):
		"""[..., nm, nt] -> [..., nmp, ntb, TT], zero padded."""
		x = torch.nn.functional.pad(x.to(self.dt), (0, self.ntp - self.nt, 0, self.nmp - self.nm))
		return x.view(x.shape[:-1] + (self.ntb, self.TT))

	def factors(self):
		"""(curr fac, prev fac): the state unscaled by its level, 0, -1 or -2."""
		one = torch.ones((), dtype=self.dt, device=self.dev)
		fac = torch.where(self.lev == 0, one, torch.where(self.lev == -1, one*2.0**-BLK_S,
			torch.where(self.lev == -2, one*2.0**(-2*BLK_S), one*0)))
		return self.curr*fac, self.prev*fac

	def chains(self, il):
		"""Yields (l, gA_c, gA_p, gB_c, gB_p), the chain values [nmp, ntb, JP]
		after the step to each degree l of block il."""
		shape = (self.nmp, self.ntb, BLK_JP)
		gAc, gBp = (torch.ones(shape, dtype=self.dt, device=self.dev) for _ in range(2))
		gAp, gBc = (torch.zeros(shape, dtype=self.dt, device=self.dev) for _ in range(2))
		for l in range(il*BLK_LB, (il + 1)*BLK_LB):
			a, b = self.a[l][:, None, None], self.b[l][:, None, None]
			gAp, gAc = gAc, a*(self.ctv*gAc - b*gAp)
			gBp, gBc = gBc, a*(self.ctv*gBc - b*gBp)
			self.ends = (gAc, gAp, gBc, gBp)
			yield l, gAc, gAp, gBc, gBp

	def to_rings(self, L):
		"""[..., nmp, ntb, JP] node values -> [..., nmp, ntb, TT] ring values."""
		return torch.einsum("...mnj,njt->...mnt", L, self.W)

	def step_state(self, il):
		"""Carry the state of the tiles running block il over it."""
		E = self.to_rings(torch.stack(self.ends))
		ncurr = E[0]*self.curr + E[2]*self.prev
		nprev = E[1]*self.curr + E[3]*self.prev
		big = torch.abs(ncurr) > 2.0**BLK_S
		act = self.start <= il
		self.prev = torch.where(act, torch.where(big, nprev*2.0**-BLK_S, nprev), self.prev)
		self.curr = torch.where(act, torch.where(big, ncurr*2.0**-BLK_S, ncurr), self.curr)
		self.lev = torch.where(act, self.lev + big.to(self.dt), self.lev)


def blk_synthesis(A, state, tab, g, lmax, mode="scalar"):
	"""The synthesis sum over the blocked suffix of degrees: for entry
	(m, t) of a tile with tab.start < ceil(nl/BLK_LB), the degrees from
	BLK_LB tab.start on, resumed from state [3, nm, nt] as the stepwise scan
	dumped it there. A [nl, nm, C] -> [nfun, C, nm, nt], zero on the other
	tiles. The twin of the kernels that replace _synth_blk_call
	(pixell_tpu/ops/sht_pallas.py:888) and _synth_blk_call_streams (:1032)."""
	run = _BlkRun(state, tab, g, lmax + 1, mode)
	nfun, NS, C = NFUN[mode], len(run.fam), A.shape[-1]
	Ap = run.pad_lm(A.to(run.dt).permute(2, 0, 1))                         # [C, nlp, nmp]
	out = torch.zeros((nfun, C, run.nmp, run.ntb, run.TT), dtype=run.dt, device=run.dev)
	for il in range(run.first, run.nlb):
		FA = torch.zeros((C, NS, run.nmp, run.ntb, BLK_JP), dtype=run.dt, device=run.dev)
		FB = torch.zeros_like(FA)
		for l, gAc, gAp, gBc, gBp in run.chains(il):
			for s, prevfam in enumerate(run.fam):
				asn = (Ap[:, l]*run.cs[s, l])[:, :, None, None]         # [C, nmp, 1, 1]
				FA[:, s] += asn*(gAp if prevfam else gAc)
				FB[:, s] += asn*(gBp if prevfam else gBc)
		currf, prevf = run.factors()
		ts = run.to_rings(FA)*currf + run.to_rings(FB)*prevf           # [C, NS, nmp, ntb, TT]
		act = run.start <= il
		for f, o in enumerate(blk_combine(mode, [ts[:, s] for s in range(NS)], *run.rings)):
			out[f] += torch.where(act, o, torch.zeros((), dtype=run.dt, device=run.dev))
		run.step_state(il)
	return out.view(nfun, C, run.nmp, run.ntp)[:, :, :run.nm, :run.nt]


def blk_analysis(F, state, tab, g, lmax, mode="scalar"):
	"""The analysis sums of the blocked suffix: for every degree l, the
	rings of the tiles that run l's block blocked (BLK_LB tab.start <= l),
	resumed from state as the stepwise scan dumped it. F [nfun, C, nm, nt]
	-> [nl, nm, C], zero below every tile's first block. The twin of the
	kernels that replace _anal_blk_call (pixell_tpu/ops/sht_pallas.py:1220)
	and _anal_blk_call_streams (:1350)."""
	run = _BlkRun(state, tab, g, lmax + 1, mode)
	nfun, NS, C = NFUN[mode], len(run.fam), F.shape[1]
	Fp = run.tiles(F)                                                   # [nfun, C, nmp, ntb, TT]
	out = torch.zeros((run.nlb*BLK_LB, run.nmp, C), dtype=run.dt, device=run.dev)
	zero = torch.zeros((), dtype=run.dt, device=run.dev)
	for il in range(run.first, run.nlb):
		act = run.start <= il
		G = torch.stack(blk_fields(mode, Fp[0], Fp[nfun - 1], *run.rings), 1)   # [C, NS, ...]
		currf, prevf = run.factors()
		# contract the rings first: Wc[m, j] = sum_t curr fac G(m, t) W(j, t)
		Wc = torch.einsum("csmnt,njt->csmnj", currf*G, run.W)
		Wp = torch.einsum("csmnt,njt->csmnj", prevf*G, run.W)
		for l, gAc, gAp, gBc, gBp in run.chains(il):
			tot = 0
			for s, prevfam in enumerate(run.fam):
				cl = run.cs[s, l][:, None, None]
				tot = tot + (gAp if prevfam else gAc)*(cl*Wc[:, s]) \
					+ (gBp if prevfam else gBc)*(cl*Wp[:, s])
			# the chains of a tile still below its seeds overflow: select, not multiply
			out[l] = torch.where(act, tot, zero).sum((-1, -2)).T
		run.step_state(il)
	return out[:run.nl, :run.nm]


def synthesis_scan(A, theta, lmax, mmax, mode="scalar", dtype=torch.float64):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c]
	(pixell_tpu.ops.sht_core.synthesis_scan :318)."""
	return synthesis(A, prepare_geom(theta, mmax, dtype, A.device), lmax, mode)

def analysis_scan(F, theta, lmax, mmax, mode="scalar", dtype=torch.float64):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t]
	(pixell_tpu.ops.sht_core.analysis_scan :323)."""
	return analysis(F, prepare_geom(theta, mmax, dtype, F.device), lmax, mode)


def wigner_synthesis_scan(A, theta, lmax, mmax, s, dtype=torch.float64):
	"""General-spin synthesis: G[f (w, x), c, m, t] = sum_l u_f(l,m,t) A[l,m,c]
	(pixell_tpu.ops.sht_core.wigner_synthesis_scan :518)."""
	return synthesis(A, prepare_geom(theta, mmax, dtype, A.device, int(s)), lmax, "wigner")

def wigner_analysis_scan(F, theta, lmax, mmax, s, dtype=torch.float64):
	"""General-spin analysis: A[l,m,c] = sum_f sum_t u_f(l,m,t) F[f,c,m,t]
	(pixell_tpu.ops.sht_core.wigner_analysis_scan :523)."""
	return analysis(F, prepare_geom(theta, mmax, dtype, F.device, int(s)), lmax, "wigner")
