"""Curved-sky harmonic analysis on ndmaps, any spin and derivatives
(counterpart of pixell_tpu/curvedsky.py).

Ports the map-level SHT path: alm_info (pixell_tpu/curvedsky.py:38),
analyse_geometry (:327), ring reorientation (:400-419), alm2map (:505) and
map2alm (:614) with deriv=, weights=, the niter Jacobi loop, the exact 2d
phase path and the ring-edge quadrature of "cyl" geometries
(_analysis_linear :686-813, weighted, non-mesh), plus rand_alm
(:253-302), rand_map (:304), get_lmax_from_map (:317), alm2cl (:132) and
almxfl (:160).

Every public function takes the reference's parameters in the
reference's order; the port's own extras come last and are keyword-only.
Parameters that mean nothing on the card (verbose, nthread, epsilon,
locinfo, tweak) are accepted and ignored, as is m_major, which the
reference ignores too (its alm are m-major either way). The entry points
that allocate (rand_alm, rand_alm_white, rand_map, prepare_alm) do so on
device="cuda" unless told otherwise; alm2map and map2alm follow the map's
device. accuracy="high" runs the Legendre recurrence in float64 whatever
the map's dtype. Theta banding
(SYNTH_BAND_BYTES) is not ported: it was sized for a 16 GB chip. Not ported
yet, and raising NotImplementedError: adjoint, the "general"
geometry method and mesh= (multi-device).
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, wcsutils, utils, sht
from . import fft as enfft
from .bunch import Bunch

_NP_CDTYPE = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def nalm2lmax(n): return sht.nalm2lmax(n)


class alm_info:
	"""Layout of 1D alm arrays (pixell_tpu.curvedsky.alm_info): triangular
	m-major by default, rectangular, or an explicit mstart array."""
	def __init__(self, lmax=None, mmax=None, nalm=None, stride=1, layout="triangular"):
		if lmax is not None: lmax = int(lmax)
		if mmax is not None: mmax = int(mmax)
		if nalm is not None: nalm = int(nalm)
		if isinstance(layout, str):
			if layout in ["triangular", "tri"]:
				if lmax is None: lmax = nalm2lmax(nalm)
				if mmax is None: mmax = lmax
				m = np.arange(mmax+1)
				mstart = stride*(m*(2*lmax+1-m)//2)
			elif layout in ["rectangular", "rect"]:
				if lmax is None: lmax = int(nalm**0.5)-1
				if mmax is None: mmax = lmax
				mstart = np.arange(mmax+1)*(lmax+1)*stride
			else:
				raise ValueError("unknown layout: %s" % layout)
		else:
			mstart = np.asarray(layout)
			if lmax is None: raise ValueError("lmax needed with explicit mstart")
			if mmax is None: mmax = len(mstart)-1
		self.lmax = lmax
		self.mmax = mmax
		self.stride = int(stride)
		self.nelem = int(np.max(mstart) + (lmax+1)*stride)
		self.mstart = mstart.astype(np.int64)
	@property
	def nl(self): return self.lmax+1
	@property
	def nm(self): return self.mmax+1
	def lm2ind(self, l, m):
		return self.mstart[np.asarray(m)] + np.asarray(l)*self.stride
	def _is_tri(self):
		m = np.arange(self.mmax+1)
		return self.stride == 1 and np.array_equal(self.mstart, m*(2*self.lmax+1-m)//2)
	def _valid_index(self):
		l = np.arange(self.lmax+1)[:, None]
		m = np.arange(self.mmax+1)[None, :]
		valid = l >= m
		return valid, np.where(valid, self.mstart[m] + l*self.stride, 0)
	def _rect(self, alm):
		"""[..., nalm] -> [..., nl, nm] (zero where l < m)."""
		if self._is_tri(): return sht.alm2rect(alm, self.lmax, self.mmax)
		valid, idx = self._valid_index()
		valid = torch.from_numpy(valid).to(alm.device)
		rect = alm[..., torch.from_numpy(idx).to(alm.device)]
		return torch.where(valid, rect, torch.zeros((), dtype=alm.dtype, device=alm.device))
	def _unrect(self, rect):
		"""[..., nl, nm] -> [..., nelem]."""
		if self._is_tri(): return sht.rect2alm(rect, self.lmax, self.mmax)
		valid, idx = self._valid_index()
		lv, mv = np.nonzero(valid)
		out = rect.new_zeros(rect.shape[:-2] + (self.nelem,))
		out[..., torch.from_numpy(idx[lv, mv]).to(rect.device)] = rect[..., lv, mv]
		return out
	def alm2cl(self, alm, alm2=None, dtype=None):
		"""Cross spectra; dtype is accepted and ignored, as in the reference."""
		return alm2cl(alm, alm2=alm2, ainfo=self)
	def lmul(self, alm, lmat, out=None):
		return lmul(alm, lmat, ainfo=self, out=out)
	def __repr__(self):
		return "alm_info(lmax=%s,mmax=%s)" % (str(self.lmax), str(self.mmax))


def alm2cl(alm, alm2=None, ainfo=None):
	"""Power/cross spectra of alm [..., nalm] -> [..., nl]
	(pixell_tpu.curvedsky.alm2cl)."""
	if ainfo is None: ainfo = alm_info(nalm=alm.shape[-1])
	if alm2 is None: alm2 = alm
	r1, r2 = ainfo._rect(alm), ainfo._rect(alm2)
	rdt = r1.real.dtype
	eps = torch.where(torch.arange(ainfo.mmax+1, device=alm.device) == 0, 1.0, 2.0).to(rdt)
	cl = torch.sum((r1*torch.conj(r2)).real*eps, -1)
	l = torch.arange(ainfo.lmax+1, device=alm.device, dtype=rdt)
	return cl/(2*l+1)

def lmul(alm, lmat, ainfo=None, out=None):
	"""Multiply alm by a per-l scalar [nl] or matrix [a, b, nl]
	(pixell_tpu.curvedsky.lmul); into out when given."""
	if ainfo is None: ainfo = alm_info(nalm=alm.shape[-1])
	lmat = torch.as_tensor(lmat, device=alm.device)
	rect = ainfo._rect(alm)
	nl = ainfo.lmax+1
	if lmat.ndim == 1:
		res = rect*lmat[:nl][:, None]
	elif lmat.ndim == 2:
		res = rect*lmat[..., :nl][..., :, None]
	else:
		res = torch.einsum("ab...l,b...lm->a...lm", lmat[..., :nl].to(rect.dtype), rect)
	res = ainfo._unrect(res).to(alm.dtype)
	if out is None: return res
	if tuple(out.shape) != tuple(res.shape):
		raise ValueError("out has shape %s, the result %s" % (tuple(out.shape), tuple(res.shape)))
	return out.copy_(res)

def almxfl(alm, lfilter=None, ainfo=None, out=None):
	"""Filter alm by a function or array of l (pixell_tpu.curvedsky.almxfl);
	into out when given."""
	if ainfo is None: ainfo = alm_info(nalm=alm.shape[-1])
	if callable(lfilter):
		lfilter = lfilter(np.arange(ainfo.lmax+1).astype(float))
	return lmul(alm, lfilter, ainfo=ainfo, out=out)


# ---------------------------------------------------------------------------
# Random alm (pixell_tpu/curvedsky.py:253-302): drawn on the host from a
# numpy default_rng(seed), so the same seed gives the reference's numbers
# ---------------------------------------------------------------------------
def _rand_alm_white_np(ainfo, pre, seed, dtype):
	rng = np.random.default_rng(seed)
	shape = tuple(pre) + (ainfo.nelem,)
	ndt = _NP_CDTYPE[dtype]
	rdt = np.float32 if ndt == np.complex64 else np.float64
	alm = np.empty(shape, ndt)
	alm.real = rng.standard_normal(shape, dtype=rdt)
	alm.imag = rng.standard_normal(shape, dtype=rdt)
	# m = 0 must be real, scaled so all modes have the same variance
	l = np.arange(ainfo.lmax+1)
	i0 = ainfo.lm2ind(l, 0*l)
	alm[..., i0] = alm[..., i0].real*np.sqrt(2)
	return alm

def rand_alm_white(ainfo, pre=None, seed=None, m_major=True, return_ainfo=False,
		dtype=torch.complex128, *, device="cuda"):
	"""Unit-variance white alm [*pre, nelem] (pixell_tpu.curvedsky.rand_alm_white);
	(alm, ainfo) with return_ainfo."""
	alm = torch.from_numpy(_rand_alm_white_np(ainfo, pre or (), seed, dtype)).to(device)
	return (alm, ainfo) if return_ainfo else alm

def rand_alm(ps, ainfo=None, lmax=None, seed=None, dtype=torch.complex128, m_major=True,
		return_ainfo=False, *, device="cuda"):
	"""Gaussian alm with power spectrum ps [nl] or [ncomp, ncomp, nl]
	(pixell_tpu.curvedsky.rand_alm)."""
	ps = np.asarray(ps)
	oned = ps.ndim == 1
	if oned: ps = ps[None, None]
	if lmax is None: lmax = ps.shape[-1]-1
	if ainfo is None: ainfo = alm_info(lmax=lmax)
	ncomp = ps.shape[0]
	alm = _rand_alm_white_np(ainfo, (ncomp,), seed, dtype)
	ps_ext = np.zeros((ncomp, ncomp, ainfo.lmax+1))
	n = min(ps.shape[-1], ainfo.lmax+1)
	ps_ext[:, :, :n] = ps[:, :, :n]
	L = np.moveaxis(utils.eigpow(np.moveaxis(ps_ext, -1, 0), 0.5), 0, -1)
	alm = alm/np.sqrt(2)
	lv = np.zeros(ainfo.nelem, int)
	for m in range(ainfo.mmax+1):
		ls = np.arange(m, ainfo.lmax+1)
		lv[ainfo.mstart[m] + ls*ainfo.stride] = ls
	Ll = L[:, :, lv].astype(alm.real.dtype)
	av = np.ascontiguousarray(alm).view(alm.real.dtype).reshape(alm.shape[0], -1, 2)
	alm = np.ascontiguousarray(np.einsum("abi,bik->aik", Ll, av)).view(alm.dtype)[..., 0]
	res = torch.from_numpy(alm[0] if oned else alm).to(device)
	return (res, ainfo) if return_ainfo else res

def rand_map(shape, wcs, ps, lmax=None, dtype=torch.float64, seed=None, spin=[0, 2],
		method="auto", verbose=False, *, device="cuda"):
	"""Random realization of ps directly in map space
	(pixell_tpu.curvedsky.rand_map :304)."""
	if lmax is None: lmax = get_lmax_from_map(Bunch(shape=shape, wcs=wcs))
	cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
	alm = rand_alm(ps, lmax=lmax, seed=seed, dtype=cdt, device=device)
	return alm2map(alm, enmap.zeros(shape, wcs, dtype, device), spin=spin, method=method)

def get_lmax_from_map(m):
	"""Nyquist-ish lmax for a cylindrical map geometry
	(pixell_tpu.curvedsky.get_lmax_from_map :317)."""
	res = np.min(np.abs(np.asarray(m.wcs.wcs.cdelt)))*utils.degree
	return int(np.pi/res)


# ---------------------------------------------------------------------------
# Geometry analysis (pixell_tpu/curvedsky.py:327-375)
# ---------------------------------------------------------------------------
def analyse_geometry(shape, wcs, tol=1e-6):
	"""Classify a geometry for SHT purposes. Returns a Bunch with
	case ("2d" | "cyl" | "general"), flip [flipy, flipx] to bring rings to
	(theta ascending, phi ascending), theta[nt], phi0, nphi, xpad and ypad
	(the ring padding that completes the quadrature grid), and variant
	("CC" | "F1" | None)."""
	if wcsutils.is_plain(wcs) or not wcsutils.is_separable(wcs):
		return Bunch(case="general", flip=[False, False], variant=None,
			theta=None, phi0=0.0, nphi=shape[-1], ypad=(0, 0), xpad=(0, 0))
	ny, nx = shape[-2:]
	dec, ra = enmap.posaxes(shape, wcs)
	theta = np.pi/2 - dec
	flipy = bool(theta[0] > theta[-1]) if ny > 1 else False
	if flipy: theta = theta[::-1]
	flipx = bool(wcs.wcs.cdelt[0] < 0)
	ra_asc = ra[::-1] if flipx else ra
	phi0 = ra_asc[0] % (2*np.pi)
	nphi_full_f = 360.0/abs(wcs.wcs.cdelt[0])
	nphi_full = int(utils.nint(nphi_full_f))
	good_x = abs(nphi_full_f - nphi_full) < tol*nphi_full
	xpad = (0, max(nphi_full - nx, 0)) if good_x else (0, 0)
	if not good_x:
		return Bunch(case="general", flip=[flipy, flipx], variant=None,
			theta=theta, phi0=phi0, nphi=nx, ypad=(0, 0), xpad=(0, 0))
	if wcsutils.get_proj(wcs) != "car":
		return Bunch(case="cyl", flip=[flipy, flipx], variant=None,
			theta=theta, phi0=phi0, nphi=nphi_full, ypad=(0, 0), xpad=xpad)
	dtheta = abs(wcs.wcs.cdelt[1])*utils.degree
	for variant, off in [("CC", 0.0), ("F1", 0.5)]:
		nfull_f = np.pi/dtheta + (1 if variant == "CC" else 0)
		nfull = int(utils.nint(nfull_f))
		if abs(nfull_f - nfull) > tol: continue
		j0_f = theta[0]/dtheta - off
		j0 = int(utils.nint(j0_f))
		if abs(j0_f - j0) > tol: continue
		if j0 < 0 or j0 + ny > nfull: continue
		return Bunch(case="2d", flip=[flipy, flipx], variant=variant,
			theta=theta, phi0=phi0, nphi=nphi_full,
			ypad=(j0, nfull - ny - j0), xpad=xpad)
	return Bunch(case="cyl", flip=[flipy, flipx], variant=None,
		theta=theta, phi0=phi0, nphi=nphi_full, ypad=(0, 0), xpad=xpad)


def _to_rings(d, minfo):
	"""Reorient the pixel axes to (theta ascending, phi ascending) and pad x
	to the full ring."""
	dims = [-2] if minfo.flip[0] else []
	if minfo.flip[1]: dims.append(-1)
	if dims: d = d.flip(dims)
	if minfo.xpad[1]: d = torch.nn.functional.pad(d, (0, minfo.xpad[1]))
	return d

def _from_rings(d, minfo, nx):
	d = d[..., :, :nx]
	dims = [-2] if minfo.flip[0] else []
	if minfo.flip[1]: dims.append(-1)
	return d.flip(dims) if dims else d

def _comp_spins(spin, ncomp):
	res = []
	for s, i1, i2 in sht._spin_blocks(spin, ncomp):
		res += [s]*(i2-i1)
	return res


# ---------------------------------------------------------------------------
# Map-level transforms
# ---------------------------------------------------------------------------
def _leg_dtype(accuracy):
	if accuracy not in (None, "fast", "default", "high"):
		raise ValueError("accuracy must be None, 'fast', 'default' or 'high'")
	return torch.float64 if accuracy == "high" else None

def _not_ported(adjoint=False, mesh=None):
	if adjoint: raise NotImplementedError("adjoint transforms are not ported yet")
	if mesh is not None: raise NotImplementedError("mesh= (multi-device) is not ported yet")


def _ctype(dtype):
	"""The complex dtype of dtype's precision."""
	return torch.complex64 if dtype in (torch.float32, torch.complex64) else torch.complex128

def _ainfo_of(alm, ainfo, lmax):
	"""The layout of alm, or of the alm prepare_alm would allocate."""
	if ainfo is not None: return ainfo
	if alm is not None: return alm_info(nalm=alm.shape[-1])
	if lmax is None: raise ValueError("prepare_alm needs alm, ainfo or lmax")
	return alm_info(lmax=lmax)

def prepare_alm(alm=None, ainfo=None, lmax=None, pre=(), dtype=torch.float64, *, device="cuda"):
	"""Allocate alm (complex of dtype's precision) and get its layout info
	(pixell_tpu.curvedsky.prepare_alm)."""
	ainfo = _ainfo_of(alm, ainfo, lmax)
	if alm is None:
		alm = torch.zeros(tuple(pre) + (ainfo.nelem,), dtype=_ctype(dtype), device=device)
	return alm, ainfo


def alm2map(alm, map, spin=[0, 2], deriv=False, adjoint=False, copy=False,
		method="auto", ainfo=None, verbose=False, nthread=None, epsilon=None,
		pix_tol=1e-6, locinfo=None, tweak=False, accuracy=None, mesh=None):
	"""Spherical harmonic synthesis of alm [..., nalm] onto map's geometry
	(pixell_tpu.curvedsky.alm2map :505). Writes the result into map (unless
	copy) and returns it. With deriv, alm is [nalm] and map [2, ny, nx]
	receives the gradient (d/ddec, d/dra). accuracy="high" runs the
	recurrence in float64."""
	_not_ported(adjoint, mesh)
	alm = torch.as_tensor(alm, device=map.device)
	if ainfo is None: ainfo = alm_info(nalm=alm.shape[-1])
	minfo = analyse_geometry(map.shape, map.wcs, tol=pix_tol)
	if method == "auto": method = minfo.case
	if method not in ["2d", "cyl"]:
		raise NotImplementedError("the '%s' geometry method is not ported yet" % method)
	alm2 = alm if (deriv or alm.ndim > 1) else alm[None]
	d = sht.synthesis(alm2, minfo.theta, minfo.nphi, phi0=minfo.phi0,
		lmax=ainfo.lmax, mmax=ainfo.mmax, spin=spin, deriv=deriv, map_dtype=map.dtype,
		leg_dtype=_leg_dtype(accuracy))
	if deriv:
		# the engine gives (d/dtheta, d/dphi); the map holds (d/ddec, d/dra)
		d = torch.stack([-d[..., 0, :, :], d[..., 1, :, :]], -3)
	elif alm.ndim == 1:
		d = d[..., 0, :, :]
	d = _from_rings(d, minfo, map.shape[-1])
	if copy: return enmap.ndmap(d, map.wcs)
	map.data = d
	return map


def map2alm(map, alm=None, lmax=None, spin=[0, 2], deriv=False, adjoint=False,
		copy=False, method="auto", ainfo=None, verbose=False, nthread=None,
		niter=0, epsilon=None, pix_tol=1e-6, weights=None, locinfo=None,
		tweak=False, accuracy=None, mesh=None):
	"""Spherical harmonic analysis of map (pixell_tpu.curvedsky.map2alm :614):
	with weights (per ring, in the map's row order), quadrature with them on
	the map's rings; else exact quadrature on 2d (CC/F1) grids
	(theta-upsampled when the grid is too coarse for lmax) and ring-edge
	weights on other cylindrical ("cyl") geometries; refined by niter Jacobi
	iterations. With deriv, map is the gradient [2, ny, nx] (d/ddec, d/dra)
	and the result one alm. Writes into alm when given, or with copy into a
	copy of it, leaving alm as it was."""
	_not_ported(adjoint, mesh)
	ainfo = _ainfo_of(alm, ainfo, lmax)
	minfo = analyse_geometry(map.shape, map.wcs, tol=pix_tol)
	if method == "auto": method = minfo.case
	if method not in ["2d", "cyl"]:
		raise NotImplementedError("map2alm on '%s' geometries is not ported yet" % method)
	ldt = _leg_dtype(accuracy)
	res = _analysis_linear(map.data, ainfo, minfo, spin, deriv, ldt, weights)
	for it in range(niter):
		approx = alm2map(res, enmap.zeros(map.shape, map.wcs, map.dtype, map.device),
			spin=spin, deriv=deriv, ainfo=ainfo, accuracy=accuracy)
		res = res + _analysis_linear(map.data - approx.data, ainfo, minfo, spin, deriv, ldt,
			weights)
	if alm is None: return res.to(_ctype(map.dtype))
	if copy: alm = alm.clone()
	alm.copy_(res)
	return alm


def _edge_weights(theta):
	"""Ring weights |cos(edge_i) - cos(edge_i+1)| from the ring midpoints,
	for rings that are no quadrature grid (pixell_tpu.curvedsky.
	_analysis_linear :798-808)."""
	th = np.asarray(theta)
	if len(th) > 1:
		edges = np.concatenate([[max(th[0]-(th[1]-th[0])/2, 0)], (th[1:]+th[:-1])/2,
			[min(th[-1]+(th[-1]-th[-2])/2, np.pi)]])
	else:
		edges = np.array([0, np.pi])
	return np.abs(np.cos(edges[:-1]) - np.cos(edges[1:]))


def _analysis_linear(arr, ainfo, minfo, spin, deriv, leg_dtype, weights=None):
	"""map pixels -> alm on a 2d or cyl geometry (pixell_tpu.curvedsky.
	_analysis_linear :686-813, weighted, non-mesh), by minfo.case as the
	reference decides. With weights, or on a cyl geometry with its ring-edge
	weights, quadrature on the map's own rings. On a 2d (full-sky
	quadrature) geometry it goes to per-ring phases first, so the y padding,
	the exact theta upsample and the quadrature run on the [nm]-wide
	spectrum and the ring FFT happens once."""
	d = _to_rings(arr, minfo)
	flat2d = (not deriv) and d.ndim == 2
	if flat2d: d = d[None]
	if deriv:
		# (d/ddec, d/dra) back to (d/dtheta, d/dphi) (alm2_pre :816)
		d = torch.stack([-d[..., 0, :, :], d[..., 1, :, :]], -3)
	if weights is not None or minfo.case != "2d":
		if weights is None: w = _edge_weights(minfo.theta)
		else: w = np.asarray(weights)[::-1] if minfo.flip[0] else weights
		a = sht.analysis(d, minfo.theta, ainfo.lmax, w, mmax=ainfo.mmax, phi0=minfo.phi0,
			spin=spin, deriv=deriv, leg_dtype=leg_dtype)
		return a[..., 0, :] if flat2d else a
	ny, nphi = d.shape[-2:]
	ntfull = ny + minfo.ypad[0] + minfo.ypad[1]
	F = sht.ring_analysis(d, minfo.phi0, ainfo.mmax+1)
	if minfo.ypad[0] or minfo.ypad[1]:
		F = torch.nn.functional.pad(F, (int(minfo.ypad[0]), int(minfo.ypad[1])))
	need = 2*ainfo.lmax + 1
	if need > ntfull:
		# a 2-3-5-7-smooth ring count keeps the torus FFT off Bluestein
		ntu = enfft.fft_len(need + 2, direction="above")
		spins = [1, 0] if deriv else _comp_spins(spin, d.shape[-3])
		F = sht.resample_theta_phase(F, minfo.variant, ntu, spins)
		ntfull = ntu
	theta_f = sht.ring_theta(minfo.variant, ntfull)
	w = sht.ring_weights(minfo.variant, ntfull)
	a = sht.analysis_phase(F, theta_f, ainfo.lmax, w, nphi, mmax=ainfo.mmax,
		spin=spin, deriv=deriv, leg_dtype=leg_dtype)
	return a[..., 0, :] if flat2d else a
