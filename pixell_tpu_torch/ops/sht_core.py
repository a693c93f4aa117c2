"""Plain PyTorch scaled Legendre recurrence: the twin of every Legendre kernel.

Counterpart of pixell_tpu/ops/sht_core.py, scalar (spin-0) mode only.
The normalized associated Legendre values lambda_lm(theta) are carried for
all (m, theta) at once through the three-term l-recurrence in a scaled
representation lambda = val * 2^(S*level), S = 850 (f64) / 60 (f32), so
that lambda_mm ~ sin^m(theta) cannot underflow near the poles. Only levels
0 and -1 can contribute above 2^-S, so unscaling is a three-way select.

Engine contract (nfun = 1 in scalar mode):
  synthesis_scan(A[nl,nm,C], theta[nt]) -> G[1,C,nm,nt],
      G[0,c,m,t] = sum_l lambda_lm(theta_t) A[l,m,c]
  analysis_scan(F[1,C,nm,nt], theta[nt]) -> A[nl,nm,C],
      A[l,m,c] = sum_t lambda_lm(theta_t) F[0,c,m,t]

This module is what the SHT runs on CPU tensors, and what every CUDA kernel
in csrc/legendre.cu is held against on the card. It is written for clarity:
a Python loop over l with whole-[nm, nt] tensor operations.
"""
from __future__ import annotations
import numpy as np
import torch

LBLOCK = 8  # the state is renormalized after every LBLOCK l-steps (l % 8 == 7)


def scale_log2(dtype):
	"""Scaled-representation chunk S (pixell_tpu.ops.sht_core._scale_log2):
	2^850 for f64, 2^60 for f32, leaving headroom below overflow for the
	growth between two renormalizations."""
	return 850 if dtype == torch.float64 else 60


def _np_dtype(dtype):
	return np.float64 if dtype == torch.float64 else np.float32


class Geom:
	"""Per-ring tables of the recurrence, all on one device:
	ct/ct_lo [nt] (two-part cos theta; ct_lo is zero in f64),
	seed_val [nm, nt] and seed_level [nm, nt] int32, the scaled lambda_mm."""
	def __init__(self, ct, ct_lo, seed_val, seed_level):
		self.ct, self.ct_lo = ct, ct_lo
		self.seed_val, self.seed_level = seed_val, seed_level
	@property
	def dtype(self): return self.ct.dtype
	@property
	def nm(self): return self.seed_val.shape[0]
	@property
	def nt(self): return self.seed_val.shape[1]


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
	th = np.asarray(theta, np.float64)
	# pole detection covers the input dtype's rounding of theta: in f32,
	# sin(fl32(pi)) = -8.7e-8 -- a ring that close to a pole is AT it
	eps_pole = 1e-12 if dtype == torch.float64 else 1e-6
	st = np.sin(th)
	st = np.where(np.abs(st) < eps_pole, 0.0, np.maximum(st, 0.0))
	nm, nt = mmax + 1, th.shape[0]
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


def prepare_geom(theta, mmax, dtype, device=None):
	"""Recurrence tables for concrete float64 ring colatitudes theta
	(pixell_tpu.ops.sht_core._prepare_geom :100), built on the host and
	moved to device."""
	if dtype not in (torch.float32, torch.float64):
		raise TypeError("Legendre recurrence dtype must be float32 or float64")
	ct, lo = ct_parts(theta, dtype)
	sv, sl = scaled_seeds(theta, mmax, dtype)
	f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
	return Geom(f(ct), f(lo), f(sv), f(sl))


def recur_ab(l, marr):
	"""Recurrence coefficients a_lm, b_lm for degree l (a Python int) and the
	m values marr, in marr's dtype (pixell_tpu/ops/sht_core.py:262-265):
	lambda_l = a ((cos theta) lambda_{l-1} - b lambda_{l-2}). Differences
	are FACTORED ((l-m)(l+m)) to dodge the l^2 - m^2 cancellation; the
	clamps keep rows with l < m finite and their state exactly 0."""
	lf = torch.tensor(float(l), dtype=marr.dtype, device=marr.device)
	a = torch.sqrt(torch.clamp((2*lf - 1)*(2*lf + 1), min=0.0)
		/ torch.clamp((lf - marr)*(lf + marr), min=0.25))
	b = torch.sqrt(torch.clamp((lf - 1 - marr)*(lf - 1 + marr), min=0.0)
		/ torch.clamp((2*lf - 3)*(2*lf - 1), min=1.0))
	return a, b


def _scan(g, lmax, A=None, F=None):
	"""The scaled recurrence over l = 0..lmax (pixell_tpu.ops.sht_core._scan_core
	:221, scalar mode). Synthesis when A [nl, nm, C] is given (returns
	[C, nm, nt]), else analysis of F [C, nm, nt] (returns [nl, nm, C])."""
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
	if A is not None:
		out = torch.zeros((A.shape[-1], nm, nt), dtype=dt, device=dev)
	else:
		out = torch.zeros((lmax + 1, nm, F.shape[0]), dtype=dt, device=dev)
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
		lam = new*fac
		prev, curr = curr, new
		if A is not None:
			out += lam[None]*A[l].T[:, :, None]
		else:
			out[l] = torch.einsum("mt,cmt->mc", lam, F)
		if l % LBLOCK == LBLOCK - 1:
			big = torch.abs(curr) > band
			prev = torch.where(big, prev*invband, prev)
			curr = torch.where(big, curr*invband, curr)
			lev = lev + big.to(torch.int32)
	return out


def synthesis(A, g, lmax):
	"""G[c,m,t] = sum_l lambda_lm(theta_t) A[l,m,c] on prepared geometry g."""
	return _scan(g, lmax, A=A.to(g.dtype))

def analysis(F, g, lmax):
	"""A[l,m,c] = sum_t lambda_lm(theta_t) F[c,m,t] on prepared geometry g."""
	return _scan(g, lmax, F=F.to(g.dtype))


def _check_mode(mode):
	if mode != "scalar":
		raise NotImplementedError("only the scalar (spin-0) Legendre mode is ported")

def synthesis_scan(A, theta, lmax, mmax, mode="scalar", dtype=torch.float64):
	"""G[0,c,m,t] = sum_l lambda_lm(theta_t) A[l,m,c]
	(pixell_tpu.ops.sht_core.synthesis_scan :318)."""
	_check_mode(mode)
	return synthesis(A, prepare_geom(theta, mmax, dtype, A.device), lmax)[None]

def analysis_scan(F, theta, lmax, mmax, mode="scalar", dtype=torch.float64):
	"""A[l,m,c] = sum_t lambda_lm(theta_t) F[0,c,m,t]
	(pixell_tpu.ops.sht_core.analysis_scan :323)."""
	_check_mode(mode)
	return analysis(F[0], prepare_geom(theta, mmax, dtype, F.device), lmax)
