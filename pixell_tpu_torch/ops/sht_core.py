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
in csrc/legendre.cu is held against on the card. It is written for clarity:
a Python loop over l with whole-[nm, nt] tensor operations.
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


def lambdas(g, lmax):
	"""The scaled recurrence over l = 0..lmax (pixell_tpu.ops.sht_core.
	_scan_core :221): yields (l, lambda_l, lambda_{l-1}), the true
	(unscaled) values as [nm, nt] tensors."""
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


def mode_values(mode, g, lmax):
	"""Yields (l, [u_f as [nm, nt] tensors]) for l = 0..lmax in any mode."""
	if (mode == "wigner") != (g.s is not None):
		raise ValueError("mode '%s' on a geometry prepared %s a spin" % (mode,
			"without" if g.s is None else "with"))
	if mode == "wigner":
		yield from wigner_values(g, lmax)
		return
	marr = torch.arange(g.nm, dtype=g.dtype, device=g.ct.device)
	for l, lam, lam1 in lambdas(g, lmax):
		yield l, mode_funcs(mode, l, marr, g, lam, lam1)


def synthesis(A, g, lmax, mode="scalar", live=None):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c] on prepared geometry g:
	A [nl, nm, C] -> [nfun, C, nm, nt]. live [nm, nt] bool, if given, marks
	the entries to compute; the others come out 0 (the kernels' dead-tile
	skip)."""
	check_mode(mode)
	A = A.to(g.dtype)
	out = torch.zeros((NFUN[mode], A.shape[-1], g.nm, g.nt), dtype=g.dtype, device=g.ct.device)
	for l, us in mode_values(mode, g, lmax):
		for f, u in enumerate(us):
			out[f] += u[None]*A[l].T[:, :, None]
	return out if live is None else out*live

def analysis(F, g, lmax, mode="scalar", live=None):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t] on prepared
	geometry g: F [nfun, C, nm, nt] -> [nl, nm, C]. live [nm, nt] bool, if
	given, marks the entries of F that are read (the kernels' dead-tile
	skip)."""
	check_mode(mode)
	F = F.to(g.dtype)
	if live is not None: F = F*live
	out = torch.zeros((lmax + 1, g.nm, F.shape[1]), dtype=g.dtype, device=g.ct.device)
	for l, us in mode_values(mode, g, lmax):
		for f, u in enumerate(us):
			out[l] += torch.einsum("mt,cmt->mc", u, F[f])
	return out


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
