"""Map analysis: matched filters and iterative source finding (counterpart
of pixell_tpu/analysis.py).

The matched filters estimate per-pixel point-source fluxes and their
uncertainties under different noise models:

  flux = rho/kappa, dflux = kappa**-0.5, snr = rho/kappa**0.5

Each filter is a chain of UHT transforms and products on the map's device
(torch.fft in flat mode, K1-K4 in curved mode). Harmonic profiles (B, iN,
iC) follow the UHT: tensors or ndmaps of the Fourier plane in flat mode
(moved to the map's device), numpy [lmax+1] in curved mode. The Nmat /
Finder / Measurer / Modeller classes are the iterative find -> measure ->
subtract source finder.

The finders' labelling is host code, as in the reference: scipy.ndimage's
label and maximum_position on the S/N threshold mask and the S/N values
above it, copied to the host, and the centres of mass (ndimage.sum_labels,
center_of_mass's own sums) over the pixels of the measurement circles. Those host stages are named in
HOST_STAGES and timed into HOST_MS (wall ms) on each call; the circles
themselves (make_circle_labels) are a labeled distance transform on the
device (K13), and only their labelled pixels come to the host.

Where the reference carries dead code (matched_filter_constcorr_lowcorr's
alpha and l, smoothivar's first kappa line, FinderSimple's grid_max) the
port gives its results without it.
"""
from __future__ import annotations
import time
import numpy as np
import torch
from . import enmap, utils, uharm, pointsrcs, curvedsky
from .bunch import Bunch

HOST_STAGES = ("snr_to_host", "label", "peaks", "center_of_mass")
HOST_MS = {name: 0.0 for name in HOST_STAGES}


class _host_stage:
	"""Adds the wall time of its block to HOST_MS[name], and marks the
	block in a profiler trace as "analysis.<name>"."""
	def __init__(self, name): self.name = name
	def __enter__(self):
		# the device's queued work first, so that the stage's time is the host's
		if torch.cuda.is_available() and torch.cuda.is_initialized(): torch.cuda.synchronize()
		self.rf = torch.profiler.record_function("analysis." + self.name)
		self.rf.__enter__()
		self.t0 = time.perf_counter()
	def __exit__(self, *exc):
		HOST_MS[self.name] += (time.perf_counter() - self.t0)*1e3
		self.rf.__exit__(*exc)


def reset_host_ms():
	for k in HOST_MS: HOST_MS[k] = 0.0


def _d(x):
	"""x's data: an ndmap's tensor, a tensor, or numpy as it is."""
	return x.data if isinstance(x, enmap.ndmap) else x


_host = enmap._host_array


def _on(x, device):
	"""x (an ndmap, a tensor or numpy) as a tensor on device."""
	x = _d(x)
	return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(device)


def _hp(uht, x, device):
	"""A harmonic profile in the UHT's representation: a tensor on device
	in flat mode, numpy in curved mode."""
	return _on(x, device) if uht.mode == "flat" else _host(x)


def _pixarea(map):
	return enmap.pixsizemap(map.shape, map.wcs, broadcastable=True, device=map.device).data


def _uht(map, uht):
	return uharm.UHT(map.shape, map.wcs, device=map.device) if uht is None else uht


def matched_filter_constcov(map, B, iN, uht=None, spin=0):
	"""Matched filter under a constant-covariance (harmonic-diagonal) noise
	model: B and iN the beam and inverse noise power as harmonic profiles.
	Returns (rho, kappa), kappa a scalar."""
	uht = _uht(map, uht)
	B, iN = _hp(uht, B, map.device), _hp(uht, iN, map.device)
	rho = uht.map2harm_adjoint(uht.hmul(B*iN, uht.map2harm(map, spin=spin)), spin=spin)
	rho = enmap.samewcs(_d(rho)/_pixarea(map), map)
	kappa = uht.sum_hprof(B**2*iN)/(4*np.pi)
	return rho, kappa

def matched_filter_white(map, B, ivar, uht=None, B2=None, high_acc=False):
	"""Matched filter for white (pixel-diagonal) noise of inverse variance
	ivar."""
	uht = _uht(map, uht)
	P = 1/_pixarea(map)
	B = _hp(uht, B, map.device)
	B2 = uht.hprof_rpow(B, 2) if B2 is None else _hp(uht, B2, map.device)
	ivm = enmap.samewcs(_on(ivar, map.device)*_d(map), map)
	rho = uht.map2harm_adjoint(uht.hmul(B, uht.harm2map_adjoint(ivm)))
	rho = enmap.samewcs(_d(rho)*P, map)
	iv = ivar if isinstance(ivar, enmap.ndmap) else enmap.ndmap(_on(ivar, map.device) + 0*_d(map), map.wcs)
	kappa = uht.map2harm_adjoint(uht.hmul(B2, uht.harm2map_adjoint(iv)))
	kappa = enmap.samewcs(_d(kappa)*P, map)
	return rho, kappa

def matched_filter_constcorr_lowcorr(map, B, ivar, iC, uht=None, B2=None, high_acc=False):
	"""Matched filter for noise N" = ivar^0.5 iC ivar^0.5 in the low-
	correlation limit: iC the inverse correlation power as a harmonic
	profile, ivar the inverse variance map. kappa is the white-noise kappa
	scaled by <iC B^2>/<B^2>."""
	uht = _uht(map, uht)
	P = 1/_pixarea(map)
	B, iC = _hp(uht, B, map.device), _hp(uht, iC, map.device)
	V = torch.sqrt(_on(ivar, map.device))
	# rho = P' B' V iC V m
	m1 = enmap.samewcs(V*_d(map), map)
	m2 = uht.harm2map(uht.hmul(iC, uht.map2harm(m1)))
	m3 = enmap.samewcs(V*_d(m2), map)
	rho = uht.map2harm_adjoint(uht.hmul(B, uht.harm2map_adjoint(m3)))
	rho = enmap.samewcs(_d(rho)*P, map)
	if B2 is None: B2 = uht.hprof_rpow(B, 2)
	scal = uht.sum_hprof(iC*B**2)/uht.sum_hprof(B**2)
	iv = ivar if isinstance(ivar, enmap.ndmap) else enmap.ndmap(_on(ivar, map.device) + 0*_d(map), map.wcs)
	kappa = uht.map2harm_adjoint(uht.hmul(B2, uht.harm2map_adjoint(iv)))
	kappa = enmap.samewcs(_d(kappa)*P*scal, map)
	return rho, kappa

def matched_filter_constcorr_smoothivar(map, B, ivar, iC, uht=None, high_acc=False):
	"""Matched filter for N" = ivar^0.5 iC ivar^0.5 with ivar varying slowly
	compared to the beam."""
	uht = _uht(map, uht)
	B, iC = _hp(uht, B, map.device), _hp(uht, iC, map.device)
	ivar = _on(ivar, map.device)
	V = torch.sqrt(ivar)
	m1 = enmap.samewcs(V*_d(map), map)
	f = uht.map2harm_adjoint(uht.hmul(B*iC, uht.map2harm(m1)))
	rho = enmap.samewcs(V*_d(f)/_pixarea(map), map)
	kappa0 = uht.sum_hprof(B**2*iC)/(4*np.pi)
	kappa = enmap.samewcs(ivar*kappa0, map)
	return rho, kappa

def safe_pow(x, p):
	"""sign(x) |x|^p: x**p that treats negative and zero values gracefully."""
	x = _d(x)
	if isinstance(x, torch.Tensor): return torch.sign(x)*torch.abs(x)**p
	x = np.asarray(x)
	return np.sign(x)*np.abs(x)**p

def solve_mapsys(kappa, rho, lim=0):
	"""(flux, dflux, snr) from (rho, kappa): tensors on rho's device, dflux a
	number where kappa is one."""
	rho, ksafe = _d(rho), _ksafe(kappa)
	return rho/ksafe, ksafe**-0.5, rho/ksafe**0.5

def _ksafe(kappa):
	"""kappa floored at 1e-300: a number, or a tensor."""
	if np.isscalar(kappa): return max(kappa, 1e-300)
	k = _d(kappa)
	return torch.clamp(k if isinstance(k, torch.Tensor) else torch.as_tensor(np.asarray(k)), min=1e-300)

def snr_split(snrs, sntol=0.25, snmin=5):
	"""The indices of snrs grouped into brightness tiers, strongest first:
	each tier's weakest at least sntol times its strongest; values below
	snmin share one tier."""
	v = np.log(np.maximum(np.abs(_host(snrs)), snmin))/np.log(1/sntol)
	v -= np.max(v) + 1e-9
	v = np.floor(v).astype(int)
	return utils.find_equal_groups(v)[::-1]

def sanitize_kappa(kappa, tol=1e-4, inplace=False):
	"""kappa with its diagonal ([ncomp, ncomp, ...]) floored at tol times
	its largest value (the whole of kappa where it has no such diagonal)."""
	k = _d(kappa)
	k = k if isinstance(k, torch.Tensor) else torch.as_tensor(np.asarray(k, float))
	if k.ndim < 4 or k.shape[0] != k.shape[1]:
		out = torch.maximum(k, torch.max(k)*tol)
		return enmap.samewcs(out, kappa) if hasattr(kappa, "wcs") else out
	diag = torch.einsum("aa...->a...", k)
	floor = torch.max(diag.reshape(diag.shape[0], -1), -1).values*tol
	floor = floor.reshape((-1,) + (1,)*(diag.ndim-1))
	i = torch.arange(k.shape[0], device=k.device)
	k = k.clone()
	k[i, i] = torch.maximum(diag, floor)
	return enmap.samewcs(k, kappa) if hasattr(kappa, "wcs") else k

def get_flat_sky_correction(pixratio):
	return (0.5*(1 + pixratio**2))**-0.5, 1/pixratio

def dtype_concat(dtypes):
	return sum([np.dtype(dtype).descr for dtype in dtypes], [])

def merge_arrays(arrays):
	"""Record arrays merged column-wise."""
	odtype = dtype_concat([a.dtype for a in arrays])
	res = np.zeros(arrays[0].shape, odtype)
	for a in arrays:
		for key in a.dtype.names:
			res[key] = a[key]
	return res

def _complex(x):
	return x.to(utils.complex_dtype(x.dtype)) if not x.is_complex() else x

def rpow(fmap, exp=2):
	"""A Fourier-space map raised to a power in real space."""
	norm = fmap.area()**0.5
	map = enmap.ifft(enmap.samewcs(_complex(_d(fmap)/norm), fmap), normalize="phys").real
	return enmap.samewcs(_d(enmap.fft(enmap.samewcs(_d(map)**exp, map), normalize="phys")).real*norm, fmap)

def rmul(*args):
	"""Fourier-space maps multiplied in real space."""
	return rop(*args, op=torch.multiply)

def rop(*args, op=None):
	"""op applied to Fourier-space maps in real space."""
	if op is None: op = torch.multiply
	norm = args[0].area()**0.5
	reals = [_d(enmap.ifft(enmap.samewcs(_complex(_d(a)/norm), args[0]), normalize="phys").real) for a in args]
	work = reals[0]
	for r in reals[1:]: work = op(work, r)
	return enmap.samewcs(_d(enmap.fft(enmap.ndmap(work, args[0].wcs), normalize="phys")).real*norm, args[0])

def get_ref(a, tol=1e-3, default=0, n=1000):
	"""A robust positive reference value of an array (host)."""
	a = _host(a)
	ref = 0
	for i in range(2):
		vals = a[a > ref]
		if vals.size == 0: return default
		step = max(1, vals.size//n)
		ref = np.median(vals[::step])
	return ref

def make_circle_labels(shape, wcs, pixs, inds=None, r=2*np.pi/180/60*2, *, device="cuda"):
	"""A label map [ny, nx] int32 on device with circles of radius r around
	the peak pixels pixs[{y, x}, n], labelled inds (1..n by default): the
	labeled distance transform (K13) of the peaks, cut at r."""
	pixs = np.asarray(pixs)
	if inds is None: inds = np.arange(1, len(pixs[0])+1)
	mask = torch.zeros(tuple(shape[-2:]), dtype=torch.int32, device=device)
	mask[torch.from_numpy(np.asarray(pixs[0], int)).to(device), torch.from_numpy(np.asarray(pixs[1], int)).to(device)] = \
		torch.from_numpy(np.asarray(inds, np.int32)).to(device)
	dists, labels = enmap.labeled_distance_transform(enmap.ndmap(mask, wcs), rmax=r)
	labels = torch.where(dists.data >= r, 0, labels.data)
	return enmap.ndmap(labels, wcs)

def get_central_radius(fbeam, lknee=2000, alpha=-3):
	"""The radius of the first zero-crossing of the (filtered) real-space
	beam of the Fourier-space beam fbeam."""
	l = enmap.modlmap(fbeam.shape, fbeam.wcs, device=fbeam.device).data
	fb = torch.mean(_d(fbeam).reshape((-1,) + fbeam.shape[-2:]), 0)
	fb = torch.nan_to_num(fb*(1 + (l/lknee)**alpha)**-1)
	rbeam = enmap.ifft(enmap.ndmap(_complex(fb), fbeam.wcs)).real
	pos = enmap.pix2sky(fbeam.shape, fbeam.wcs, np.array([[0.0], [0.0]]))[:, 0]
	br, r = enmap.rbin(rbeam, center=pos)
	br, r = _host(br), _host(r)
	br = br/br[0]
	neg = np.nonzero(br < 0)[0]
	return r[neg[0]] if len(neg) else r[-1]


# ---------------------------------------------------------------------------
# Noise models
# ---------------------------------------------------------------------------
class Nmat:
	"""Base class of the noise models the finders take."""
	def matched_filter(self, map): raise NotImplementedError
	def simulate(self): raise NotImplementedError
	def sim(self, seed=None): return self.simulate(seed=seed)

def _sim_harm(uht, hN, seed):
	"""A map of spectrum hN drawn by uht.hrand, on the UHT's device. (The
	reference's curved branch names curvedsky, which it does not import,
	and raises NameError.)"""
	r = uht.hrand(hN, seed=seed)
	if uht.mode == "flat": return enmap.ifft(r).real
	omap = enmap.zeros(tuple(r.shape[:-1]) + tuple(uht.shape), uht.wcs, utils.real_dtype(r.dtype), device=r.device)
	return curvedsky.alm2map(r, omap)

class NmatConstcov(Nmat):
	def __init__(self, iN, B, uht):
		self.iN, self.B, self.uht = iN, B, uht
	def matched_filter(self, map):
		return matched_filter_constcov(map, self.B, self.iN, uht=self.uht)
	def simulate(self, seed=None):
		"""A noise realization of covariance N = iN^-1."""
		return _sim_harm(self.uht, safe_pow(_hp(self.uht, self.iN, self.uht.device), -1), seed)

class NmatWhite(Nmat):
	def __init__(self, ivar, B, uht):
		self.ivar, self.B, self.uht = ivar, B, uht
		self.B2 = uht.hprof_rpow(_hp(uht, B, uht.device), 2)
	def matched_filter(self, map):
		return matched_filter_white(map, self.B, self.ivar, uht=self.uht, B2=self.B2)
	def simulate(self, seed=None):
		"""White noise of variance 1/ivar where ivar > 0, numpy's
		default_rng(seed) as the reference draws it."""
		rng = np.random.default_rng(seed)
		iv = _host(self.ivar)
		sig = np.where(iv > 0, np.abs(iv)**-0.5, 0.0)
		dev = _d(self.ivar).device if isinstance(_d(self.ivar), torch.Tensor) else self.uht.device
		return enmap.samewcs(torch.from_numpy(rng.standard_normal(iv.shape)*sig).to(dev), self.ivar)

class NmatConstcorr(Nmat):
	def __init__(self, iC, ivar, B, uht):
		self.iC, self.ivar, self.B, self.uht = iC, ivar, B, uht
		self.B2 = None
	def matched_filter(self, map):
		# B's square in real space, a constant of the model, made once (the
		# reference makes it in each call)
		if self.B2 is None: self.B2 = self.uht.hprof_rpow(_hp(self.uht, self.B, map.device), 2)
		return matched_filter_constcorr_lowcorr(map, self.B, self.ivar, self.iC, uht=self.uht, B2=self.B2)
	def simulate(self, seed=None):
		"""Correlated noise modulated by the inverse variance map."""
		sim = _sim_harm(self.uht, safe_pow(_hp(self.uht, self.iC, self.uht.device), -1), seed)
		iv = _on(self.ivar, sim.device)
		mod = torch.where(iv > 0, torch.abs(iv)**-0.5, 0.0)
		return enmap.samewcs(_d(sim)*mod, sim)


# ---------------------------------------------------------------------------
# Finders, measurers, modellers
# ---------------------------------------------------------------------------
_CAT = [("dec", "f8"), ("ra", "f8"), ("flux", "f8"), ("dflux", "f8"), ("snr", "f8")]

def _at_t(x, py, px):
	"""x [..., ny, nx] (its first component) at the pixels (py, px), a
	tensor on x's device."""
	x = _d(x)
	if not isinstance(x, torch.Tensor): x = torch.as_tensor(np.asarray(x))
	x = x.reshape((-1,) + tuple(x.shape[-2:]))[0]
	return x[torch.as_tensor(np.asarray(py, np.int64)).to(x.device), torch.as_tensor(np.asarray(px, np.int64)).to(x.device)]

def _at(x, py, px):
	"""_at_t as numpy: only the values are copied."""
	return _at_t(x, py, px).cpu().numpy()

def _dflux_at(dflux, py, px):
	if isinstance(_d(dflux), torch.Tensor) and _d(dflux).ndim >= 2: return _at(dflux, py, px)
	return np.zeros(len(np.atleast_1d(py))) + float(_host(dflux))

def _peaks(snr, snmin):
	"""The host labelling of snr > snmin (snr [ny, nx], or its first
	component): (nlab, the peak pixels [{y, x}, nlab], snr there). The
	threshold is taken on snr's device and the mask and the values above
	it copied to the host (snr_to_host); ndimage.label labels the mask
	(label) and ndimage.maximum_position finds each label's peak among
	those values in row-major order (peaks), which is the peak it finds in
	the whole map, without its sort of every pixel."""
	from scipy import ndimage
	snr = _d(snr)
	if not isinstance(snr, torch.Tensor): snr = torch.as_tensor(np.asarray(snr))
	snr = snr.reshape((-1,) + tuple(snr.shape[-2:]))[0]
	with _host_stage("snr_to_host"):
		above = snr > snmin
		vals = snr[above].cpu().numpy()
		mask = above.cpu().numpy()
	with _host_stage("label"):
		labels, nlab = ndimage.label(mask)
	if nlab == 0: return 0, np.zeros((2, 0), int), np.zeros(0)
	with _host_stage("peaks"):
		idx = np.flatnonzero(mask)
		pos = np.array(ndimage.maximum_position(vals, labels.reshape(-1)[idx], np.arange(1, nlab+1)))[:, 0]
		pixs = np.array(np.unravel_index(idx[pos], mask.shape))
	return nlab, pixs, vals[pos]

class FinderSimple:
	"""Sources as the peaks above an S/N threshold of the matched-filter map."""
	def __init__(self, nmat, snmin=5, grid_max=True):
		self.nmat = nmat
		self.snmin = snmin
	def __call__(self, map):
		rho, kappa = self.nmat.matched_filter(map)
		flux, dflux, snr = solve_mapsys(kappa, rho)
		nlab, pixs, peak_snr = _peaks(snr, self.snmin)
		cat = np.zeros(nlab, _CAT)
		if nlab > 0:
			pos = enmap.pix2sky(map.shape, map.wcs, pixs.astype(float))
			cat["dec"], cat["ra"] = pos[0], pos[1]
			cat["flux"] = _at(flux, pixs[0], pixs[1])
			cat["dflux"] = _dflux_at(dflux, pixs[0], pixs[1])
			cat["snr"] = peak_snr
		return Bunch(cat=cat, snr=snr, flux=flux, dflux=dflux, rho=rho, kappa=kappa)

class MeasurerSimple:
	"""Fluxes at known positions from the matched-filter maps."""
	def __init__(self, nmat):
		self.nmat = nmat
	def __call__(self, map, cat):
		rho, kappa = self.nmat.matched_filter(map)
		flux, dflux, snr = solve_mapsys(kappa, rho)
		poss = np.array([cat["dec"], cat["ra"]])
		pix = np.round(np.asarray(enmap.sky2pix(map.shape, map.wcs, poss))).astype(int)
		out = cat.copy()
		iy = np.clip(pix[0], 0, map.shape[-2]-1)
		ix = np.clip(pix[1], 0, map.shape[-1]-1)
		out["flux"] = _at(flux, iy, ix)
		out["snr"] = _at(snr, iy, ix)
		out["dflux"] = _dflux_at(dflux, iy, ix)
		return Bunch(cat=out)

class ModellerPerpix:
	"""A model map of a catalogue: its beam profile painted at each source."""
	def __init__(self, shape, wcs, beam_prof, dtype=np.float64, *, device="cuda"):
		self.shape, self.wcs = shape, wcs
		self.beam_prof = beam_prof
		self.dtype = dtype
		self.device = device
	def __call__(self, cat):
		if len(cat) == 0: return enmap.zeros(self.shape, self.wcs, self.dtype, device=self.device)
		poss = np.array([cat["dec"], cat["ra"]])
		amps = np.asarray(cat["flux"], self.dtype)
		return pointsrcs.sim_objects(self.shape, self.wcs, poss, amps, self.beam_prof, dtype=self.dtype,
			device=self.device)

class FinderIterative:
	"""Find, model, subtract and find again, niter times."""
	def __init__(self, finder, modeller, niter=3, mindist_deg=0.1):
		self.finder = finder
		self.modeller = modeller
		self.niter = niter
	def __call__(self, map):
		resid = map
		cats = []
		for i in range(self.niter):
			res = self.finder(resid)
			if len(res.cat) == 0: break
			cats.append(res.cat)
			model = self.modeller(res.cat)
			resid = enmap.samewcs(_d(resid) - _d(model).to(map.device), map)
		cat = np.concatenate(cats) if cats else np.zeros(0, _CAT)
		return Bunch(cat=cat, resid=resid, model=self.modeller(cat))

class FinderMulti:
	"""Objects matching the best of several profiles: a matched filter per
	profile, the highest-S/N template per detection."""
	def __init__(self, nmats, snmin=5):
		self.nmats = nmats
		self.snmin = snmin
	def __call__(self, map):
		results = []
		for nmat in self.nmats:
			rho, kappa = nmat.matched_filter(map)
			results.append(solve_mapsys(kappa, rho))
		snrs = torch.stack([_d(r[2]) for r in results])
		snr_best, best = torch.max(snrs, 0).values, torch.argmax(snrs, 0)
		nlab, pixs, peak_snr = _peaks(snr_best, self.snmin)
		cat = np.zeros(nlab, _CAT + [("profile", "i4")])
		if nlab > 0:
			bi = _at(best, pixs[0], pixs[1])
			pos = enmap.pix2sky(map.shape, map.wcs, pixs.astype(float))
			cat["dec"], cat["ra"], cat["profile"] = pos[0], pos[1], bi
			cat["snr"] = peak_snr
			for i in np.unique(bi):
				sel = bi == i
				flux, dflux, snr = results[i]
				cat["flux"][sel] = _at(flux, pixs[0][sel], pixs[1][sel])
				cat["dflux"][sel] = _dflux_at(dflux, pixs[0][sel], pixs[1][sel])
		return Bunch(cat=cat, snr=snr_best)

def _center_of_mass(w, labels, index):
	"""ndimage.center_of_mass(w, labels, index) from the labelled pixels
	alone: labels [ny, nx] and w [ny, nx] on the device; the pixels with a
	label come to the host in row-major order, where ndimage.sum_labels
	sums them as center_of_mass does (the same sums in the same order)."""
	from scipy import ndimage
	lab = _d(labels)
	with _host_stage("center_of_mass"):
		nz = torch.nonzero(lab.reshape(-1) != 0)[:, 0]
		flat = lab.reshape(-1)[nz].cpu().numpy()
		ww = _d(w).reshape(-1)[nz].cpu().numpy()
		y, x = np.divmod(nz.cpu().numpy(), lab.shape[-1])
		norm = ndimage.sum_labels(ww, flat, index)
		return np.array([ndimage.sum_labels(ww*y.astype(float), flat, index)/norm,
			ndimage.sum_labels(ww*x.astype(float), flat, index)/norm])

class FinderMultiSafe:
	"""Like FinderMulti, but each object measured only over the pixels of a
	circle around its own peak (constant-radius labels per profile case)."""
	def __init__(self, nmats, snmin=5, r=None):
		"""nmats: the noise models, one per profile case; r: each case's
		measurement radius in radians (2 arcmin each by default)."""
		self.nmats = nmats
		self.snmin = snmin
		if r is None: r = [2*np.pi/180/60]*len(nmats)
		self.rs = np.atleast_1d(r)*np.ones(len(nmats))
	def __call__(self, map, snmin=None):
		if snmin is None: snmin = self.snmin
		results = []
		snr_tot, cases = None, None
		for ca, nmat in enumerate(self.nmats):
			rho, kappa = nmat.matched_filter(map)
			# solve_mapsys's snr; its flux and dflux are taken at the objects only
			ksafe = _ksafe(sanitize_kappa(kappa))
			snr = _d(rho)/ksafe**0.5
			results.append((_d(rho), ksafe, snr))
			if snr_tot is None:
				snr_tot = snr
				cases = torch.zeros(snr.shape, dtype=torch.int8, device=snr.device)
			else:
				mask = snr > snr_tot
				cases = torch.where(mask, ca, cases)
				snr_tot = torch.where(mask, snr, snr_tot)
		nlab, pixs0, peak_snr = _peaks(snr_tot, snmin)
		dtype = _CAT + [("case", "i4")]
		if nlab == 0:
			return Bunch(cat=np.zeros(0, dtype).view(np.recarray), snr=enmap.samewcs(snr_tot, map), snmin=snmin)
		cat = np.zeros(nlab, dtype).view(np.recarray)
		cat.case = _at(cases, pixs0[0], pixs0[1])
		cat.snr = peak_snr
		for ca in range(len(self.nmats)):
			sel = np.nonzero(cat.case == ca)[0]
			if len(sel) == 0: continue
			rho, ksafe, snr = results[ca]
			my_labels = make_circle_labels(map.shape, map.wcs, pixs0[:, sel], inds=sel+1, r=self.rs[ca],
				device=map.device)
			pixs = _center_of_mass(snr**2, my_labels, sel+1)
			pos = enmap.pix2sky(map.shape, map.wcs, pixs)
			cat.dec[sel], cat.ra[sel] = pos[0], pos[1]
			ip = np.round(pixs).astype(int)
			ip[0] = np.clip(ip[0], 0, map.shape[-2]-1)
			ip[1] = np.clip(ip[1], 0, map.shape[-1]-1)
			k = _at_t(ksafe, ip[0], ip[1]) if ksafe.ndim >= 2 else ksafe
			cat.flux[sel] = _host(_at_t(rho, ip[0], ip[1])/k)
			cat.dflux[sel] = _host(k**-0.5)
		cat = cat[np.argsort(cat.snr)[::-1]]
		return Bunch(cat=cat, snr=enmap.samewcs(snr_tot, map), snmin=snmin)


class NmatWavelet(Nmat):
	"""Wavelet-diagonal noise model: the noise variance per wavelet scale and
	position, iN = W' diag(1/var) W."""
	def __init__(self, wt, noise_map=None, B=None, smooth_pix=8):
		"""wt: a wavelets.WaveletTransform; noise_map: a noise realization or
		residual map to calibrate the per-scale variances from."""
		self.wt = wt
		self.B = B
		self.vars = None
		self.smooth_pix = smooth_pix
		if noise_map is not None:
			self.calibrate(noise_map)
	def calibrate(self, noise_map):
		"""Each scale's variance: its square smoothed by a uniform filter of
		smooth_pix pixels (scipy.ndimage, host), floored at 1e-4 of its mean."""
		from scipy import ndimage
		wave = self.wt.map2wave(noise_map)
		self.vars = []
		for m in wave.maps:
			v = ndimage.uniform_filter(_host(m)**2, size=self.smooth_pix)
			self.vars.append(torch.from_numpy(np.maximum(v, np.mean(v)*1e-4)).to(_d(m).device))
		return self
	def apply_iN(self, map):
		"""N" map = W' diag(1/var) W map."""
		from . import multimap
		wave = self.wt.map2wave(map)
		whitened = multimap.ndmaps([enmap.ndmap(_d(m)/v.to(_d(m).device), m.wcs)
			for m, v in zip(wave.maps, self.vars)])
		return self.wt.wave2map(whitened)
	def matched_filter(self, map):
		"""rho = P'B' N" m; kappa from the mean of the scales' inverse
		variances (percent-level, as the reference)."""
		uht = self.wt.uht
		iNm = self.apply_iN(map)
		P = 1/_pixarea(map)
		B = None if self.B is None else _hp(uht, self.B, map.device)
		rho = iNm if B is None else uht.map2harm_adjoint(uht.hmul(B, uht.harm2map_adjoint(iNm)))
		rho = enmap.samewcs(_d(rho).to(map.device)*P, map)
		ivar_eff = sum(1.0/v.to(map.device) for v in self.vars)/len(self.vars)
		ivar_map = enmap.ndmap(ivar_eff*0 + ivar_eff, map.wcs)
		if B is not None:
			B2 = uht.hprof_rpow(B, 2)
			kappa = uht.map2harm_adjoint(uht.hmul(B2, uht.harm2map_adjoint(ivar_map)))
			kappa = enmap.samewcs(_d(kappa)*P, map)
		else:
			kappa = ivar_map
		return rho, kappa


def matched_filter_constcorr_dual(map, B, ivar, iC, uht=None, S=None, iS=None):
	"""Matched filter for the dual constant-correlation model
	iN = iC^0.5 ivar iC^0.5."""
	uht = _uht(map, uht)
	pixarea = _pixarea(map)
	W = _d(uht.quad_weights()).to(map.device)
	B, iC = _hp(uht, B, map.device), _hp(uht, iC, map.device)
	hC = iC**0.5
	BC2 = uht.hprof_rpow(B*hC, 2)
	if S is None: S = lambda x: x
	if iS is None: iS = lambda x: x
	inner = uht.harm2map(uht.hmul(hC, uht.map2harm(S(map))))
	inner = enmap.samewcs(_on(ivar, map.device)*_d(iS(inner)), map)
	inner = uht.harm2map(uht.hmul(hC, uht.map2harm(S(inner))))
	rho = uht.harm2map(uht.hmul(B, uht.map2harm(iS(inner))))
	rho = enmap.samewcs(_d(rho)/pixarea, map)
	kappa = uht.map2harm_adjoint(uht.hmul(BC2, uht.harm2map_adjoint(enmap.samewcs(_on(ivar, map.device)*W, map))))
	kappa = enmap.samewcs(_d(kappa)/pixarea**2, map)
	return rho, kappa


class Finder:
	def __call__(self, map): raise NotImplementedError

class Measurer:
	def __call__(self, map, cat): raise NotImplementedError

class Modeller:
	def __call__(self, cat): raise NotImplementedError
	def amplitudes(self, cat): raise NotImplementedError


class MeasurerMulti(Measurer):
	"""Each catalogue case measured by its own measurer."""
	def __init__(self, measurers):
		self.measurers = measurers
	def __call__(self, map, icat):
		cat = icat.copy()
		if len(icat) == 0: return Bunch(cat=cat)
		uvals, order, edges = utils.find_equal_groups_fast(icat["case"])
		for i, ca in enumerate(uvals):
			sel = order[edges[i]:edges[i+1]]
			if len(sel) == 0: continue
			cat[sel] = self.measurers[int(ca)](map, icat[sel]).cat
		return Bunch(cat=cat)


class MeasurerIterative(Measurer):
	"""Measurement in brightness tiers, the models of brighter tiers
	subtracted first."""
	def __init__(self, measurer, modeller, sntol=0.25, snscale=1):
		self.measurer = measurer
		self.modeller = modeller
		self.sntol = sntol
		self.snscale = snscale
		self.snmin = 0.1
	def __call__(self, map, icat, verbose=False):
		cat = icat.copy()
		if cat.size == 0:
			return Bunch(cat=cat, model=self.modeller(cat))
		snr = icat["snr"]*self.snscale
		groups = snr_split(snr, sntol=self.sntol, snmin=self.snmin)
		model = torch.zeros_like(_d(map))
		for gi, group in enumerate(groups):
			group = np.asarray(group, int)
			if verbose:
				print("Measuring group %d with snmin %6.2f" % (gi+1, np.min(np.asarray(snr)[group])))
			resid = enmap.samewcs(_d(map) - model, map)
			subcat = self.measurer(resid, icat[group]).cat
			model = model + _d(self.modeller(subcat)).to(model.device)
			cat[group] = subcat
		return Bunch(cat=cat, model=enmap.samewcs(model, map))


def _beam_profiles(beam_profiles):
	return [np.array([r, b/np.max(b)]) for r, b in beam_profiles]

class ModellerPerfreq(Modeller):
	"""The catalogue painted once per frequency's beam profile, fluxes per
	frequency."""
	def __init__(self, shape, wcs, beam_profiles, dtype=np.float32, nsigma=5, *, device="cuda"):
		self.shape, self.wcs = shape, wcs
		self.dtype, self.nsigma, self.device = dtype, nsigma, device
		self.beam_profiles = _beam_profiles(beam_profiles)
		self.areas = np.array([utils.calc_beam_area(p) for p in self.beam_profiles])
	def __call__(self, cat):
		ncomp = len(self.beam_profiles)
		if len(cat) == 0:
			return enmap.zeros((ncomp,) + tuple(self.shape[-2:]), self.wcs, self.dtype, device=self.device)
		flux = np.asarray(cat["flux"])
		outs = []
		for i in range(ncomp):
			fi = flux if flux.ndim == 1 else flux[:, i]
			srcparam = np.stack([np.asarray(cat["dec"]), np.asarray(cat["ra"]), fi/self.areas[i]], -1)
			outs.append(_d(pointsrcs.sim_srcs(tuple(self.shape[-2:]), self.wcs, srcparam, self.beam_profiles[i],
				dtype=self.dtype, nsigma=self.nsigma, device=self.device)))
		return enmap.ndmap(torch.stack(outs), self.wcs)
	def amplitudes(self, cat):
		bpeaks = np.array([p[1, 0] for p in self.beam_profiles])
		return np.asarray(cat["flux"])*(bpeaks/self.areas)


def _flux_tot(cat):
	return np.asarray(cat["flux_tot"]) if "flux_tot" in cat.dtype.names else np.asarray(cat["flux"])

class ModellerScaled(Modeller):
	"""The catalogue's total flux painted scaled per frequency."""
	def __init__(self, shape, wcs, beam_profiles, scaling, dtype=np.float32, nsigma=5, *, device="cuda"):
		self.shape, self.wcs = shape, wcs
		self.dtype, self.nsigma, self.device = dtype, nsigma, device
		self.scaling = np.asarray(scaling)
		self.beam_profiles = _beam_profiles(beam_profiles)
		self.areas = np.array([utils.calc_beam_area(p) for p in self.beam_profiles])
	def __call__(self, cat):
		ncomp = len(self.beam_profiles)
		if len(cat) == 0:
			return enmap.zeros((ncomp,) + tuple(self.shape[-2:]), self.wcs, self.dtype, device=self.device)
		ftot = _flux_tot(cat)
		outs = []
		for i in range(ncomp):
			srcparam = np.stack([np.asarray(cat["dec"]), np.asarray(cat["ra"]),
				ftot*self.scaling[i]/self.areas[i]], -1)
			outs.append(_d(pointsrcs.sim_srcs(tuple(self.shape[-2:]), self.wcs, srcparam, self.beam_profiles[i],
				dtype=self.dtype, nsigma=self.nsigma, device=self.device)))
		return enmap.ndmap(torch.stack(outs), self.wcs)
	def amplitudes(self, cat):
		bpeaks = np.array([p[1, 0] for p in self.beam_profiles])
		return _flux_tot(cat)[:, None]*(self.scaling*bpeaks/self.areas)


class ModellerMulti(Modeller):
	"""Each catalogue case painted by its own modeller, the maps summed."""
	def __init__(self, modellers):
		self.modellers = modellers
	def __call__(self, cat):
		if len(cat) == 0: return self.modellers[0](cat)
		uvals, order, edges = utils.find_equal_groups_fast(cat["case"])
		omap = None
		for i, ca in enumerate(uvals):
			subcat = cat[order[edges[i]:edges[i+1]]]
			if len(subcat) == 0: continue
			m = self.modellers[int(ca)](subcat)
			omap = m if omap is None else enmap.samewcs(_d(omap) + _d(m), m)
		return omap
	def amplitudes(self, cat):
		res = np.zeros(np.asarray(cat["flux"]).shape)
		if len(cat) == 0: return res
		uvals, order, edges = utils.find_equal_groups_fast(cat["case"])
		for i, ca in enumerate(uvals):
			sel = order[edges[i]:edges[i+1]]
			res[sel] = self.modellers[int(ca)].amplitudes(cat[sel])
		return res
