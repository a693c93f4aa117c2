"""Ring-based spherical harmonic transforms, any spin and derivatives
(counterpart of pixell_tpu/sht.py).

Maps are [..., nt, nphi] tensors with rings at colatitudes theta[nt], each
sampled at phi_j = phi0 + 2 pi j/nphi. The Legendre stage is
ops.sht_cuda (the hand-written kernels on CUDA, the plain scan on CPU); the
ring stage is torch.fft.

alm are triangular m-major (healpy-compatible): index = m(2 lmax+1-m)/2 + l.
The rectangular [nl, nm] view is an index gather with cached index
tensors; the reference's pad/reshape fold is a TPU-only design and is not
ported. Spins 1 and 2 use closed-form mode functions of the Legendre
recurrence; higher spins the Wigner-d engine (ops.sht_core wigner_values).
"""
from __future__ import annotations
import contextlib
import functools
import numpy as np
import torch
from . import fft as enfft
from .ops import sht_cuda, tablecache

_CDTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_RDTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64}


ACCURACY_HIGH = False   # set by accuracy("high"): the recurrence runs in float64


@contextlib.contextmanager
def accuracy(mode):
	"""Scope the default of the transforms' accuracy (pixell_tpu.sht.accuracy
	:48): mode None keeps the current one, "fast" or "default" runs the
	Legendre recurrence in the map's dtype, "high" in float64 whatever the
	map's dtype. curvedsky's accuracy= arguments set it for their call;
	inside, every transform whose leg_dtype is not given follows it:

	    with sht.accuracy("high"):
	        alm = curvedsky.map2alm(map, lmax=2000)
	"""
	global ACCURACY_HIGH
	if mode not in (None, "fast", "default", "high"):
		raise ValueError("accuracy must be None, 'fast', 'default' or 'high'")
	old = ACCURACY_HIGH
	ACCURACY_HIGH = old if mode is None else (mode == "high")
	try: yield
	finally: ACCURACY_HIGH = old


@contextlib.contextmanager
def blocked(enable=True):
	"""Scope the block-Legendre split (pixell_tpu.sht.blocked :62): inside,
	the float32 scalar, deriv, spin-1 and spin-2 transforms at lmax >=
	ops.sht_cuda.BLK_MINL on ring sets that take K3/K4 (not south-symmetric,
	or more than 2 SYM_MAX_NH rings) run each tile's oscillatory degrees 112
	at a time, as value series at 128 Chebyshev nodes plus one node -> ring
	product, instead of stepwise. Off by default:

	    with sht.blocked():
	        alm = curvedsky.map2alm(map, lmax=2000)
	"""
	old = sht_cuda.BLK_ENABLE
	sht_cuda.BLK_ENABLE = bool(enable)
	try: yield
	finally: sht_cuda.BLK_ENABLE = old


# ---------------------------------------------------------------------------
# alm layout (pixell_tpu/sht.py:125-324)
# ---------------------------------------------------------------------------
def nalm(lmax, mmax=None):
	if mmax is None: mmax = lmax
	return (mmax+1)*(2*lmax+2-mmax)//2

def nalm2lmax(n):
	return int((-1 + (1 + 8*n)**0.5)/2) - 1

def lm2ind(lmax, l, m):
	l = np.asarray(l); m = np.asarray(m)
	return m*(2*lmax+1-m)//2 + l


@tablecache.cached
def _rect_index(lmax, mmax, device):
	"""(gather index [nl*nm] into the triangular alm, validity mask [nl, nm],
	gather index [nalm] into the flat rect) for (lmax, mmax) on device."""
	l = np.arange(lmax+1)[:, None]
	m = np.arange(mmax+1)[None, :]
	valid = l >= m
	idx = np.where(valid, m*(2*lmax+1-m)//2 + l, 0)
	mv, lv = np.nonzero(valid.T)             # m-major order = triangular order
	tri = lv*(mmax+1) + mv                    # (l, m) -> flat rect index
	f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
	return f(idx.reshape(-1)), f(valid), f(tri)


def alm2rect(alm, lmax, mmax=None):
	"""Triangular alm [..., nalm] -> rectangular [..., nl, nm] (l-major, zero
	for l < m), by index gather (pixell_tpu.sht.alm2rect :269)."""
	if mmax is None: mmax = lmax
	idx, valid, _ = _rect_index(lmax, mmax, alm.device)
	rect = alm[..., idx].reshape(alm.shape[:-1] + (lmax+1, mmax+1))
	return torch.where(valid, rect, torch.zeros((), dtype=alm.dtype, device=alm.device))


def rect2alm(rect, lmax, mmax=None):
	"""Rectangular [..., nl, nm] -> triangular [..., nalm], by index gather
	(pixell_tpu.sht.rect2alm :297)."""
	if mmax is None: mmax = lmax
	_, _, tri = _rect_index(lmax, mmax, rect.device)
	return rect.reshape(rect.shape[:-2] + (-1,))[..., tri]


# ---------------------------------------------------------------------------
# Quadrature weights and ring positions (host-side; pixell_tpu/sht.py:350-390)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def ring_weights(variant, n):
	"""Exact weights w[n] with sum_j w_j f(theta_j) = int_0^pi f sin(theta)
	dtheta for f any cosine polynomial of degree < n.
	variant "CC": theta_j = j pi/(n-1) (pole rings included);
	variant "F1": theta_j = (j+1/2) pi/n."""
	from scipy.fft import dct
	k = np.arange(n, dtype=np.float64)
	I = np.zeros(n)
	kk = k[k != 1]
	I[k != 1] = (1 + np.cos(kk*np.pi))/(1 - kk**2 + (kk == 1))
	variant = variant.upper()
	if variant in ["CC", "CLENSHAW-CURTIS"]:
		N = n - 1
		eps = np.ones(n); eps[0] = eps[-1] = 0.5
		y = eps*I
		s = (dct(y, type=1) + y[0] + np.where(k.astype(int) % 2 == 0, 1, -1)*y[-1])/2
		return (2.0/N)*eps*s
	elif variant in ["F1", "FEJER1"]:
		return dct(I, type=3)/n
	elif variant in ["F2", "FEJER2"]:
		theta = (np.arange(n)+1)*np.pi/(n+1)
		C = np.cos(np.outer(np.arange(n), theta))
		return np.linalg.lstsq(C, I, rcond=None)[0]
	raise ValueError("Unknown ring layout '%s'" % variant)

def ring_theta(variant, n):
	variant = variant.upper()
	if variant in ["CC", "CLENSHAW-CURTIS"]:
		return np.arange(n)*np.pi/(n-1)
	elif variant in ["F1", "FEJER1"]:
		return (np.arange(n)+0.5)*np.pi/n
	elif variant in ["F2", "FEJER2"]:
		return (np.arange(n)+1)*np.pi/(n+1)
	raise ValueError("Unknown ring layout '%s'" % variant)


# ---------------------------------------------------------------------------
# Ring FFT stage (pixell_tpu/sht.py:491-561, FFT paths only)
# ---------------------------------------------------------------------------
def _phase_ramp(nm, phi0, cdtype, sign, device):
	"""exp(sign i m phi0), m = 0..nm-1, evaluated on the host in float64: a
	working-precision m*phi0 product carries ~1e-3 rad of error at m ~ 1e4.
	Cached per arguments, so the host -> device copy happens once; callers
	must not write into it."""
	return _phase_ramp_cached(int(nm), float(phi0), cdtype, int(sign), torch.device(device))

@tablecache.cached
def _phase_ramp_cached(nm, phi0, cdtype, sign, device):
	ph = sign*np.arange(nm)*phi0
	return torch.from_numpy(np.cos(ph) + 1j*np.sin(ph)).to(device=device, dtype=cdtype)


def ring_synthesis(G, phi0, nphi):
	"""G[..., nm, nt] complex -> map [..., nt, nphi]:
	map(t, j) = sum_{m=0}^{mmax} eps_m Re[G[m,t] e^{i m (phi0 + 2 pi j/nphi)}].
	m >= nphi aliases onto m mod nphi (pixell_tpu.sht.ring_synthesis :491)."""
	nm = G.shape[-2]
	if float(phi0) != 0.0:
		G = G*_phase_ramp(nm, phi0, G.dtype, +1, G.device)[:, None]
	Gt = G.movedim(-2, -1)  # [..., nt, nm]
	if nm <= nphi//2:
		# no aliasing: place m directly in the rfft half-spectrum
		g = Gt.new_zeros(Gt.shape[:-1] + (nphi//2 + 1,))
		g[..., :nm] = Gt
		return torch.fft.irfft(g, n=nphi, dim=-1)*nphi
	# aliasing-safe general path: the full complex spectrum; m = 0 counts once
	c = Gt.new_zeros(Gt.shape[:-1] + (nphi,))
	m = torch.arange(nm, device=G.device)
	c.index_add_(-1, m % nphi, Gt)
	c.index_add_(-1, (-m) % nphi, Gt.conj()*(m > 0))
	return torch.fft.ifft(c, dim=-1).real*nphi


def ring_analysis(maps, phi0, nm):
	"""map [..., nt, nphi] -> F[..., nm, nt] with
	F[m, t] = sum_j map(t, j) e^{-i m phi_j} (pixell_tpu.sht.ring_analysis :534)."""
	nphi = maps.shape[-1]
	if nm <= nphi//2 + 1:
		F = torch.fft.rfft(maps, dim=-1)[..., :nm]
	else:
		spec = torch.fft.fft(maps, dim=-1)
		F = spec[..., torch.arange(nm, device=maps.device) % nphi]
	if float(phi0) != 0.0:
		F = F*_phase_ramp(nm, phi0, F.dtype, -1, maps.device)
	return F.movedim(-1, -2)


# ---------------------------------------------------------------------------
# complex <-> real coefficient stacks for the real-valued Legendre engine
# ---------------------------------------------------------------------------
def _c2coef(z):
	"""[..., K, nl, nm] complex -> [..., nl, nm, 2K] real."""
	r = torch.view_as_real(z)                 # [..., K, nl, nm, 2]
	r = r.movedim(-4, -2)                     # [..., nl, nm, K, 2]
	return r.reshape(r.shape[:-2] + (-1,))

def _coef2c(r, K):
	"""[..., C, nm, nt] real with C = 2K -> [..., K, nm, nt] complex."""
	r = r.reshape(r.shape[:-3] + (K, 2) + tuple(r.shape[-2:]))
	return torch.complex(r[..., 0, :, :], r[..., 1, :, :])


def alm2coef(alm, lmax, mmax=None):
	"""Triangular complex alm [..., K, nalm] -> real [..., nl, nm, 2K]
	(pixell_tpu.sht.alm2coef :586)."""
	if mmax is None: mmax = lmax
	return _c2coef(alm2rect(alm, lmax, mmax))


def _spin_blocks(spin, ncomp):
	"""(spin, first, last) component blocks (pixell_tpu.sht._spin_blocks
	:599): a spin-0 block is one component, a spin-s block two."""
	blocks = []
	i = 0; si = 0
	spins = np.atleast_1d(spin).astype(int)
	while i < ncomp:
		s = int(spins[min(si, len(spins)-1)])
		step = 1 if s == 0 else 2
		if i + step > ncomp: step, s = ncomp - i, 0
		blocks.append((s, i, i+step))
		i += step; si += 1
	return blocks


def _mul_i(z):
	"""i*z (pixell_tpu.sht._mul_i :405)."""
	return torch.complex(-z.imag, z.real)


def _spin_mode(s):
	"""(engine mode, its spin argument) of a spin-s block: the closed-form
	modes for s = 1, 2, the Wigner-d engine above."""
	return ("spin%d" % s, None) if s <= 2 else ("wigner", s)


def _leg_dtype(dtype, leg_dtype=None):
	"""Recurrence dtype: leg_dtype if given, else float64 under
	accuracy("high"), else the map's real dtype."""
	if leg_dtype is not None: return leg_dtype
	return torch.float64 if (dtype == torch.float64 or ACCURACY_HIGH) else torch.float32


# ---------------------------------------------------------------------------
# Transforms. alm: [..., ncomp, nalm] complex; maps [..., ncomp, nt, nphi].
# ---------------------------------------------------------------------------
def synthesis(alm, theta, nphi, phi0=0.0, lmax=None, mmax=None, spin=(0, 2),
		deriv=False, map_dtype=None, *, leg_dtype=None):
	"""alm [..., ncomp, nalm] -> map [..., ncomp, nt, nphi]
	(pixell_tpu.sht.synthesis :617). If deriv, alm is [nalm] and the
	output is [2, nt, nphi], the (d/dtheta, d/dphi) derivatives of the
	scalar synthesis. leg_dtype sets the recurrence dtype (default: the
	map's)."""
	if map_dtype is None: map_dtype = _RDTYPE[alm.dtype]
	G = synthesis_phase(alm, theta, lmax, mmax, spin, deriv,
		leg_dtype=_leg_dtype(map_dtype, leg_dtype))
	return ring_synthesis(G, phi0, nphi).to(map_dtype)


def synthesis_phase(alm, theta, lmax=None, mmax=None, spin=(0, 2), deriv=False, *,
		leg_dtype=None):
	"""The Legendre stage of synthesis: alm [..., ncomp, nalm] -> per-ring
	phases G[..., ncomp, nm, nt] (complex, alm's precision), with
	synthesis = ring_synthesis(synthesis_phase(...)); with deriv, alm is
	[nalm] and G [2, nm, nt] (d/dtheta, d/dphi). The counterpart of
	adjoint_synthesis_phase, through the same kernels."""
	theta = np.asarray(theta, np.float64)
	if lmax is None: lmax = nalm2lmax(alm.shape[-1])
	if mmax is None: mmax = lmax
	rdt = _RDTYPE[alm.dtype]
	ldt = _leg_dtype(rdt, leg_dtype)
	if deriv:
		A = _c2coef(alm2rect(alm, lmax, mmax)[..., None, :, :])    # [nl, nm, 2]
		G = sht_cuda.synthesis_scan(A, theta, lmax, mmax, "deriv", dtype=ldt)
		Gc = _coef2c(G.to(rdt), 1)[..., 0, :, :]                    # [2(fun), nm, nt]
		m = torch.arange(mmax+1, dtype=rdt, device=alm.device)[:, None]
		return torch.stack([Gc[1], _mul_i(m*Gc[0])])
	return _phases(lambda i1, i2: alm2coef(alm[..., i1:i2, :], lmax, mmax), alm.shape[-2], theta,
		lmax, mmax, spin, rdt, ldt, 0)


def _phases(coef, ncomp, theta, lmax, mmax, spin, rdt, ldt, m0):
	"""The Legendre stage of synthesis by spin block, from coef(i1, i2), the
	real coefficient columns [nl, nm, 2k] of components i1 .. i2 - 1 on the
	m block m0 .. mmax (the whole transform at m0 = 0): per-ring phases
	[ncomp, nm, nt]."""
	outs = []
	for s, i1, i2 in _spin_blocks(spin, ncomp):
		A = coef(i1, i2)
		if s == 0:
			G = sht_cuda.synthesis_scan(A, theta, lmax, mmax, "scalar", dtype=ldt, m0=m0)
			outs.append(_coef2c(G.to(rdt), i2-i1)[0])          # [k, nm, nt]
			continue
		mode, ws = _spin_mode(s)
		G = sht_cuda.synthesis_scan(A, theta, lmax, mmax, mode, dtype=ldt, s=ws, m0=m0)
		Gc = _coef2c(G.to(rdt), 2)                            # [2(fun), 2(EB), nm, nt]
		# P1_m = -(w a_E + i x a_B), P2_m = -(w a_B - i x a_E)
		outs.append(torch.stack([-(Gc[0, 0] + _mul_i(Gc[1, 1])), -(Gc[0, 1] - _mul_i(Gc[1, 0]))]))
	return torch.cat(outs, -3)


def synthesis_rect_phase(rect, theta, lmax=None, mmax=None, spin=(0, 2), *, m0=0,
		leg_dtype=None):
	"""The Legendre stage of synthesis_rect: rect [ncomp, nl, nm] (l-major,
	zero for l < m) -> per-ring phases [ncomp, nm, nt] of the same m
	columns. With m0, rect holds the m block m0 .. mmax (mmax defaults to
	m0 + nm - 1), which runs on its own: the stage is elementwise in m, so
	an m-sharded rect needs no communication here (the port's form of the
	reference's GSPMD partition of synthesis_rect, sht.py:667)."""
	theta = np.asarray(theta, np.float64)
	if lmax is None: lmax = rect.shape[-2] - 1
	if mmax is None: mmax = m0 + rect.shape[-1] - 1
	if rect.shape[-1] != mmax + 1 - m0:
		raise ValueError("rect has %d m columns, the block %d .. %d %d" % (rect.shape[-1], m0, mmax,
			mmax + 1 - m0))
	rdt = _RDTYPE[rect.dtype]
	return _phases(lambda i1, i2: _c2coef(rect[..., i1:i2, :, :]), rect.shape[-3], theta, lmax,
		mmax, spin, rdt, _leg_dtype(rdt, leg_dtype), m0)


def synthesis_rect(rect, theta, nphi, phi0=0.0, lmax=None, mmax=None, spin=(0, 2),
		map_dtype=None, *, m0=0, leg_dtype=None):
	"""Like synthesis, but from the rectangular complex representation
	rect [ncomp, nl, nm] (l-major, zero for l < m)
	(pixell_tpu.sht.synthesis_rect :667). With m0, rect holds the m block
	m0 .. mmax, and the result is that block's share of the map (the other
	m columns taken as zero)."""
	if map_dtype is None: map_dtype = _RDTYPE[rect.dtype]
	G = synthesis_rect_phase(rect, theta, lmax, mmax, spin, m0=m0,
		leg_dtype=_leg_dtype(map_dtype, leg_dtype))
	if m0: G = torch.nn.functional.pad(G, (0, 0, m0, 0))
	return ring_synthesis(G, phi0, nphi).to(map_dtype)


def analysis_rect(maps, theta, lmax, weights, mmax=None, phi0=0.0, spin=(0, 2), *, m0=0,
		leg_dtype=None):
	"""Quadrature analysis returning the rectangular complex representation
	[ncomp, nl, nm] instead of the triangular alm
	(pixell_tpu.sht.analysis_rect :699); with m0, the columns of the m
	block m0 .. mmax only."""
	if mmax is None: mmax = lmax
	nphi = maps.shape[-1]
	w = _ring_weights_on(weights, nphi, maps.dtype, maps.device)
	F = ring_analysis(maps*w[:, None], phi0, mmax+1)[..., m0:, :]
	# m_degeneracy=False: quadrature wants each (l, m) once (no real-map m > 0
	# doubling)
	return adjoint_synthesis_phase(F, theta, lmax, mmax=mmax, spin=spin, rect_out=True,
		m_degeneracy=False, leg_dtype=leg_dtype, m0=m0)


def adjoint_synthesis_phase(F, theta, lmax, mmax=None, spin=(0, 2), deriv=False,
		alm_dtype=None, rect_out=False, m_degeneracy=True, *, leg_dtype=None, m0=0):
	"""Transpose of synthesis from the per-ring phases F[..., ncomp, nm, nt]
	(pixell_tpu.sht.adjoint_synthesis_phase :734); with deriv, F is
	[2, nm, nt] (d/dtheta, d/dphi) and the result one alm.
	m_degeneracy=False skips the real-map m > 0 doubling (for quadrature
	analysis); rect_out returns [..., ncomp, nl, nm] instead of alm. With
	m0, F holds the m block m0 .. mmax and the result its rect columns
	(rect_out only)."""
	theta = np.asarray(theta, np.float64)
	if mmax is None: mmax = lmax
	if m0 and not rect_out:
		raise ValueError("an m block (m0 = %d) gives its rect columns: pass rect_out=True" % m0)
	rdt = _RDTYPE[F.dtype]
	ldt = _leg_dtype(rdt, leg_dtype)
	cdt = _CDTYPE[rdt] if alm_dtype is None else alm_dtype
	fac = torch.where(torch.arange(m0, mmax+1, device=F.device) == 0, 1.0, 2.0).to(rdt)
	def finish(rect):
		if m_degeneracy: rect = rect*fac
		return rect if rect_out else rect2alm(rect, lmax, mmax)
	if deriv:
		m = torch.arange(m0, mmax+1, dtype=rdt, device=F.device)[:, None]
		# transpose of G_dp = i m G_s: F_s = -i m F_dp
		Fc = torch.stack([-_mul_i(m*F[1]), F[0]])[:, None]      # [2(fun), 1, nm, nt]
		Fr = torch.cat([Fc.real, Fc.imag], -3)                   # [2(fun), 2, nm, nt]
		A = sht_cuda.analysis_scan(Fr, theta, lmax, mmax, "deriv", dtype=ldt, m0=m0).to(rdt)
		return finish(torch.complex(A[..., 0], A[..., 1])).to(cdt)
	outs = []
	for s, i1, i2 in _spin_blocks(spin, F.shape[-3]):
		Fm = F[..., i1:i2, :, :]                              # [k, nm, nt]
		k = i2 - i1
		if s == 0:
			Fr = torch.stack([Fm.real, Fm.imag], -3)          # [k, 2, nm, nt]
			Fr = Fr.reshape(Fr.shape[:-4] + (1, 2*k) + tuple(Fr.shape[-2:]))
			A = sht_cuda.analysis_scan(Fr, theta, lmax, mmax, "scalar", dtype=ldt, m0=m0).to(rdt)
		else:
			Qf, Uf = Fm[0], Fm[1]
			# a_E = -sum w Q - i sum x U ;  a_B = -sum w U + i sum x Q
			Fc = torch.stack([torch.stack([-Qf, -Uf]), torch.stack([-_mul_i(Uf), _mul_i(Qf)])])
			Fr = torch.stack([Fc.real[:, 0], Fc.imag[:, 0], Fc.real[:, 1], Fc.imag[:, 1]], 1)
			mode, ws = _spin_mode(s)
			A = sht_cuda.analysis_scan(Fr, theta, lmax, mmax, mode, dtype=ldt, s=ws, m0=m0).to(rdt)
		A = A.reshape(A.shape[:-1] + (k, 2))
		outs.append(finish(torch.complex(A[..., 0], A[..., 1]).movedim(-1, -3)))   # [k, nl, nm]
	return torch.cat(outs, -3 if rect_out else -2).to(cdt)


def adjoint_synthesis(maps, theta, lmax, mmax=None, phi0=0.0, spin=(0, 2), deriv=False,
		alm_dtype=None, m_degeneracy=True, *, leg_dtype=None):
	"""Exact transpose of synthesis: map -> alm, no quadrature weights
	(pixell_tpu.sht.adjoint_synthesis :723)."""
	if mmax is None: mmax = lmax
	F = ring_analysis(maps, phi0, mmax+1)
	return adjoint_synthesis_phase(F, theta, lmax, mmax=mmax, spin=spin, deriv=deriv,
		alm_dtype=alm_dtype, m_degeneracy=m_degeneracy, leg_dtype=leg_dtype)


def _ring_weights_on(weights, nphi, dtype, device):
	"""weights[nt] * 2 pi/nphi as a dtype tensor on device, computed on the
	host as the reference does, and cached per weights, nphi, dtype and
	device, so the host -> device copy happens once; callers must not write
	into it."""
	w = np.ascontiguousarray(weights)
	return _ring_weights_cached(w.tobytes(), w.dtype.str, w.shape, int(nphi), dtype,
		torch.device(device))

@tablecache.cached
def _ring_weights_cached(wbytes, wdtype, wshape, nphi, dtype, device):
	w = np.frombuffer(wbytes, wdtype).reshape(wshape)
	return torch.as_tensor(w*(2*np.pi/nphi), dtype=dtype, device=device)


def analysis(maps, theta, lmax, weights, mmax=None, phi0=0.0, spin=(0, 2), deriv=False,
		alm_dtype=None, *, leg_dtype=None):
	"""Quadrature analysis: ring weights times 2 pi/nphi, then the transpose
	of synthesis without the m > 0 doubling (pixell_tpu.sht.analysis :807).
	Exact for band-limited maps on full-sky CC/F1 grids."""
	nphi = maps.shape[-1]
	w = _ring_weights_on(weights, nphi, maps.dtype, maps.device)
	return adjoint_synthesis(maps*w[:, None], theta, lmax, mmax=mmax, phi0=phi0,
		spin=spin, deriv=deriv, alm_dtype=alm_dtype, m_degeneracy=False, leg_dtype=leg_dtype)


def analysis_phase(F, theta, lmax, weights, nphi, mmax=None, spin=(0, 2), deriv=False,
		alm_dtype=None, *, leg_dtype=None, m0=0, rect_out=False):
	"""Quadrature analysis from phase coefficients F[..., ncomp, nm, nt]
	(pixell_tpu.sht.analysis_phase :835); nphi is the ring length F came
	from. rect_out and m0 as in adjoint_synthesis_phase: with m0, F holds
	the m block m0 .. mmax and the result is its rect columns."""
	if mmax is None: mmax = lmax
	w = _ring_weights_on(weights, nphi, F.real.dtype, F.device)
	return adjoint_synthesis_phase(F*w, theta, lmax, mmax=mmax, spin=spin, deriv=deriv,
		alm_dtype=alm_dtype, m_degeneracy=False, leg_dtype=leg_dtype, m0=m0, rect_out=rect_out)


def _undo_m_degeneracy(alm, lmax, mmax):
	"""alm [..., nalm] with the m > 0 entries halved (pixell_tpu.sht.
	_undo_m_degeneracy :825): the m = 0 block is the first lmax + 1 entries
	of the triangular layout."""
	n = nalm(lmax, mmax)
	fac = torch.where(torch.arange(n, device=alm.device) <= lmax, 1.0, 0.5)
	return alm*fac.to(_RDTYPE[alm.dtype])


def adjoint_analysis(alm, theta, nphi, weights, phi0=0.0, lmax=None, mmax=None,
		spin=(0, 2), deriv=False, map_dtype=None, *, leg_dtype=None):
	"""Transpose of analysis: the m > 0 alm halved, synthesis, then the ring
	weights times 2 pi/nphi (pixell_tpu.sht.adjoint_analysis :973)."""
	if lmax is None: lmax = nalm2lmax(alm.shape[-1])
	if mmax is None: mmax = lmax
	maps = synthesis(_undo_m_degeneracy(alm, lmax, mmax), theta, nphi, phi0=phi0, lmax=lmax,
		mmax=mmax, spin=spin, deriv=deriv, map_dtype=map_dtype, leg_dtype=leg_dtype)
	return maps*_ring_weights_on(weights, nphi, maps.dtype, maps.device)[:, None]


# ---------------------------------------------------------------------------
# Exact theta resampling of phase coefficients on the torus
# (pixell_tpu/sht.py:921-970, FFT chain)
# ---------------------------------------------------------------------------
MCHUNK_RESAMPLE = 1024  # m-columns per resample chunk (bounds the torus buffers)

def resample_theta_phase(F, variant, nt_out, spins, *, m0=0):
	"""Exactly resample phase coefficients F[..., ncomp, nm, nt] on a
	full-sky CC/F1 ring grid to nt_out rings of the same variant, via the
	torus extension in the m-domain: the phi -> phi + pi shift of the
	southern extension is the factor (-1)^m (pixell_tpu.sht.
	resample_theta_phase :921 by way of _resample_theta_phase_jit :948).
	With m0, F's columns are m = m0 .. m0 + nm - 1 (an m block)."""
	nm = F.shape[-2]
	variant = variant.upper()
	spins = tuple(int(s) for s in spins)
	parts = [_resample_theta_phase(F[..., i0:i0+MCHUNK_RESAMPLE, :], variant,
		int(nt_out), spins, m0 + i0) for i0 in range(0, nm, MCHUNK_RESAMPLE)]
	return parts[0] if len(parts) == 1 else torch.cat(parts, -2)


@tablecache.cached
def _resample_tables(m0, nm, spins, rdt, cdt, NT_in, NT_out, device):
	"""The host-built factors of _resample_theta_phase, cached so that their
	host -> device copies happen once (callers must not write into them):
	(-1)^m [nm, 1], (-1)^s [nspin, 1, 1], and the half-sample shift ramps
	exp(-+ i pi k/NT) of the Fejer-1 torus for NT_in and NT_out."""
	m = np.arange(m0, m0 + nm)
	sgn_m = torch.as_tensor(np.where(m % 2 == 0, 1.0, -1.0), dtype=rdt, device=device)[:, None]
	sgn_s = torch.as_tensor([(-1.0)**s for s in spins], dtype=rdt, device=device)[:, None, None]
	ramp = lambda n, sign: torch.from_numpy(np.exp(sign*1j*np.pi*np.fft.fftfreq(n))).to(device, cdt)
	return sgn_m, sgn_s, ramp(NT_in, -1), ramp(NT_out, 1)


def _resample_theta_phase(F, variant, nt_out, spins, m0):
	nm, nt = F.shape[-2:]
	f1 = variant in ["F1", "FEJER1"]
	# CC: pole rows are shared
	NT_in, NT_out = (2*nt, 2*nt_out) if f1 else (2*(nt-1), 2*(nt_out-1))
	sgn_m, sgn_s, ramp_in, ramp_out = _resample_tables(int(m0), int(nm), spins, F.real.dtype,
		F.dtype, NT_in, NT_out, F.device)
	mirror = (F if f1 else F[..., 1:-1]).flip(-1)*sgn_m*sgn_s
	ft = torch.fft.fft(torch.cat([F, mirror], -1), dim=-1)
	if f1: ft = ft*ramp_in
	ft = enfft.resample(ft, NT_out, axes=(-1,))/NT_in*NT_out
	if f1: ft = ft*ramp_out
	return torch.fft.ifft(ft, dim=-1)[..., :nt_out]


def resample_theta_phase_adjoint(G, variant, nt_in, spins):
	"""The transpose of resample_theta_phase(F, variant, nt_out, spins) for F
	with nt_in rings: G[..., ncomp, nm, nt_out] -> [..., ncomp, nm, nt_in].
	The resample is complex-linear, so its transpose over the real and
	imaginary parts is its conjugate transpose: Re<resample(F), G> =
	Re<F, resample_theta_phase_adjoint(G)>. Each step of the FFT chain is
	taken back in the reverse order, in the same m chunks."""
	nm = G.shape[-2]
	variant = variant.upper()
	spins = tuple(int(s) for s in spins)
	parts = [_resample_theta_phase_adjoint(G[..., i0:i0+MCHUNK_RESAMPLE, :], variant,
		int(nt_in), spins, i0) for i0 in range(0, nm, MCHUNK_RESAMPLE)]
	return parts[0] if len(parts) == 1 else torch.cat(parts, -2)


def _resample_theta_phase_adjoint(G, variant, nt, spins, m0):
	nm, nt_out = G.shape[-2:]
	f1 = variant in ["F1", "FEJER1"]
	NT_in, NT_out = (2*nt, 2*nt_out) if f1 else (2*(nt-1), 2*(nt_out-1))
	sgn_m, sgn_s, ramp_in, ramp_out = _resample_tables(int(m0), int(nm), spins, G.real.dtype,
		G.dtype, NT_in, NT_out, G.device)
	# [..., :nt_out] of an ifft, back: zero padding, then fft/NT_out
	ft = torch.fft.fft(torch.nn.functional.pad(G, (0, NT_out - nt_out)), dim=-1)/NT_out
	if f1: ft = ft*ramp_out.conj()
	ft = enfft._resample_t(ft, NT_in)/NT_in*NT_out
	if f1: ft = ft*ramp_in.conj()
	X = torch.fft.ifft(ft, dim=-1)*NT_in
	# the torus concatenation, back: the mirrored half folds onto the rows it came from
	back = X[..., nt:].flip(-1)*sgn_m*sgn_s
	F = X[..., :nt]
	if f1: return F + back
	return torch.cat([F[..., :1], F[..., 1:-1] + back, F[..., -1:]], -1)


# ---------------------------------------------------------------------------
# Exact theta resampling of maps on the torus (pixell_tpu/sht.py:991-1037)
# ---------------------------------------------------------------------------
def _torus_extend(maps, variant, spins):
	"""maps [..., ncomp, nt, nphi] on a full-sky CC/F1 grid -> (torus
	[..., ncomp, NT, nphi] complex, theta uniform over [0, 2 pi), nphi)
	(pixell_tpu.sht._torus_extend :991): the southern extension is the map
	shifted by pi in phi, times (-1)^s per component."""
	nphi = maps.shape[-1]
	fphi = torch.fft.fft(maps, dim=-1)
	phase = torch.from_numpy(np.where(np.arange(nphi) % 2 == 0, 1.0, -1.0)).to(fphi.device,
		fphi.real.dtype)
	sgn = torch.tensor([(-1.0)**s for s in spins], dtype=fphi.real.dtype,
		device=fphi.device)[:, None, None]
	rows = fphi if variant.upper() in ["F1", "FEJER1"] else fphi[..., 1:-1, :]   # CC: poles shared
	torus_f = torch.cat([fphi, rows.flip(-2)*phase*sgn], -2)
	return torch.fft.ifft(torus_f, dim=-1), nphi


def resample_theta(maps, variant, nt_out, spins, phase_only=False):
	"""Exactly resample a full-sky CC/F1 ring map [..., ncomp, nt, nphi] to
	nt_out rings of the same variant, band-limited to lmax < NT/2 on the
	torus (pixell_tpu.sht.resample_theta :1007): resample_theta_phase on the
	rings' full phi spectrum, whose index k takes the place of m (the phi ->
	phi + pi shift of the torus extension is (-1)^k). phase_only is accepted
	and ignored, as in the reference."""
	F = torch.fft.fft(maps, dim=-1).movedim(-1, -2)
	G = resample_theta_phase(F, variant, nt_out, spins)
	res = torch.fft.ifft(G.movedim(-2, -1), dim=-1)
	return res if maps.is_complex() else res.real.to(maps.dtype)
