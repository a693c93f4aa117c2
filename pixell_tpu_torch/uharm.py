"""Unified harmonic transforms: one interface over flat-sky FFTs and
curved-sky SHTs (counterpart of pixell_tpu/uharm.py).

The transforms follow the device of the map or harmonic coefficients they
are given; hrand, quad_weights and lmap put their results on the UHT's
device ("cuda" unless told otherwise). The construction is host work
(geometry, numpy profiles), and so are the profile helpers (rprof2hprof,
hprof2rprof, hprof_rpow in curved mode, the l-profiles). mesh= (a
DeviceMesh, parallel.mesh) runs the curved map2harm and harm2map over
torch.distributed, as curvedsky.map2alm / alm2map(mesh=) do; flat mode
ignores it, as in the reference.
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, curvedsky, utils, wcsutils
from .parallel import mesh as pmesh


class UHT:
	"""Unified Harmonic Transform: 2D Fourier analysis ("flat") or spherical
	harmonic analysis ("curved") behind one interface, chosen from the map's
	distortion by "auto" (pixell_tpu.uharm.UHT :9)."""
	def __init__(self, shape, wcs, mode="auto", lmax=None, max_distortion=0.1, tweak=False, mesh=None, *,
			device="cuda"):
		self.mesh = pmesh.check(mesh)
		self.shape, self.wcs = tuple(shape[-2:]), wcs
		self.device = torch.device(device)
		if mode == "auto":
			dist = estimate_distortion(shape, wcs)
			mode = "flat" if dist <= max_distortion else "curved"
		self.mode = mode
		self.area = float(enmap.area(self.shape, wcs))
		self.fsky = self.area/(4*np.pi)
		if mode == "flat":
			self._l = None   # the host |l| map, made on first use (see l)
			self.lmax = int(float(enmap.modlmap(shape, wcs, device=self.device).data.max())) if lmax is None else lmax
			# modes per unit power for sums
			self.nper = 1/self.fsky
			self.ntot = self.nper*self.shape[-2]*self.shape[-1]
		else:
			if lmax is None:
				lmax = min(curvedsky.get_lmax_from_map(Dummy(shape, wcs)), 2*10**4)
			self.lmax = lmax
			self._l = np.arange(lmax+1, dtype=float)
			self.ainfo = curvedsky.alm_info(lmax=lmax)
			self.nper = 2*np.arange(lmax+1) + 1
			self.ntot = int(np.sum(self.nper))
	@property
	def l(self):
		"""The multipoles: |l| of each Fourier pixel (host numpy, made on
		first use: a survey map's is gigabytes) in flat mode, 0..lmax in
		curved mode."""
		if self._l is None: self._l = enmap.modlmap(self.shape, self.wcs, device="cpu").data.numpy()
		return self._l
	@property
	def npix(self): return int(np.prod(self.shape[-2:]))
	@property
	def nharm(self):
		return self.npix if self.mode == "flat" else self.ainfo.nelem
	def _zeros(self, harm):
		"""The map the curved synthesis of harm writes: harm's pre-dimensions,
		its real precision, on its device."""
		return enmap.zeros(tuple(harm.shape[:-1]) + self.shape, self.wcs, utils.real_dtype(harm.dtype),
			device=harm.device)
	def map2harm(self, map, spin=0):
		if self.mode == "flat":
			return enmap.map2harm(map, spin=np.atleast_1d(spin), normalize="phys")
		return curvedsky.map2alm(map, ainfo=self.ainfo, lmax=self.lmax, spin=np.atleast_1d(spin),
			mesh=self.mesh)
	def harm2map(self, harm, spin=0):
		if self.mode == "flat":
			return enmap.harm2map(_aswcs(harm, self), spin=np.atleast_1d(spin), normalize="phys").real
		harm = torch.as_tensor(harm)
		return curvedsky.alm2map(harm, self._zeros(harm), ainfo=self.ainfo, spin=np.atleast_1d(spin),
			mesh=self.mesh)
	def map2harm_adjoint(self, harm, spin=0):
		if self.mode == "flat":
			return enmap.map2harm_adjoint(_aswcs(harm, self), spin=np.atleast_1d(spin), normalize="phys")
		harm = torch.as_tensor(harm)
		return curvedsky.map2alm(self._zeros(harm), alm=harm, adjoint=True, ainfo=self.ainfo,
			spin=np.atleast_1d(spin))
	def harm2map_adjoint(self, map, spin=0):
		if self.mode == "flat":
			return enmap.harm2map_adjoint(map, spin=np.atleast_1d(spin), normalize="phys")
		return curvedsky.alm2map_adjoint(map, ainfo=self.ainfo, spin=np.atleast_1d(spin))
	def quad_weights(self):
		"""The quadrature weight of each pixel, on the UHT's device."""
		if self.mode == "flat":
			return enmap.pixsizemap(self.shape, self.wcs, broadcastable=True, device=self.device)
		w = curvedsky.quad_weights(self.shape, self.wcs)
		return enmap.ndmap(torch.from_numpy(np.asarray(w)[:, None]).to(self.device), self.wcs)
	def rprof2hprof(self, br, r):
		"""A radial profile br(r) -> its harmonic profile."""
		if self.mode == "flat":
			return profile2harm_flat_2d(br, r, self.shape, self.wcs, device=self.device)
		return curvedsky.profile2harm(br, r, lmax=self.lmax)
	def hprof2rprof(self, harm, r):
		"""A harmonic profile -> the radial profile at the radii r (numpy)."""
		if self.mode == "flat":
			return harm2profile_flat_2d(_aswcs(harm, self), r)
		return curvedsky.harm2profile(np.asarray(harm), r)
	def hprof2harm(self, hprof):
		"""An l-profile expanded onto the full harmonic layout: per (l, m)
		in curved mode, itself in flat mode."""
		if self.mode == "flat":
			return hprof.clone() if isinstance(hprof, torch.Tensor) else np.array(hprof)
		ls = self.ainfo.get_map()[:, 0]
		return np.asarray(hprof)[..., ls]
	def mean_hprof(self, hprof):
		"""The mean of an l-profile over all modes."""
		hprof = _host(hprof)
		if self.mode == "flat":
			return np.sum(hprof*self.nper, (-2, -1))/self.ntot
		return np.sum(hprof*self.nper, -1)/self.ntot
	def lprof2hprof(self, lprof):
		"""A 1d l-profile -> the internal harmonic representation: a map of
		|l| on the UHT's device in flat mode, numpy [lmax+1] in curved."""
		lprof = np.asarray(lprof)
		if self.mode == "flat":
			l = np.minimum(self.l.astype(int), lprof.shape[-1]-1)
			return enmap.ndmap(torch.from_numpy(np.ascontiguousarray(lprof[..., l])).to(self.device), self.wcs)
		res = np.zeros(lprof.shape[:-1] + (self.lmax+1,))
		n = min(lprof.shape[-1], self.lmax+1)
		res[..., :n] = lprof[..., :n]
		return res
	def hmul(self, hprof, harm, inplace=False):
		"""A harmonic object times an l-profile in the internal representation."""
		if self.mode == "flat":
			h = _data(harm)
			return enmap.samewcs(_data(hprof).to(h.device)*h, harm)
		harm = torch.as_tensor(harm)
		hprof = np.asarray(hprof)
		if hprof.ndim == 1:
			return curvedsky.almxfl(harm, hprof, ainfo=self.ainfo)
		return curvedsky.lmul(harm, torch.from_numpy(hprof).to(harm.device), ainfo=self.ainfo)
	def hprof_rpow(self, hprof, pow):
		"""An l-profile raised to a power in real space: to a radial profile,
		the power, back."""
		if self.mode == "flat":
			# 2D Fourier profile -> real-space profile b = IFFT(B)/pixarea -> power -> back
			pa = enmap.pixsize(self.shape, self.wcs)
			m = enmap.ifft(enmap.ndmap(_data(hprof), self.wcs), normalize=True).real
			b = m.data/(pa*np.sqrt(np.prod(self.shape[-2:])))
			bp = torch.sign(b)*torch.abs(b)**pow
			return enmap.fft(enmap.ndmap(bp, self.wcs), normalize=False).real*pa
		hprof = np.asarray(hprof)
		lmax = hprof.shape[-1]-1
		theta = np.linspace(0, np.pi, 4*lmax+4)
		br = curvedsky.harm2profile(hprof, theta)
		brp = np.sign(br)*np.abs(br)**pow
		return curvedsky.profile2harm(brp, theta, lmax=lmax)
	def hrand(self, hprof, seed=None):
		"""A random realization with harmonic-space spectrum hprof, on the
		UHT's device."""
		if self.mode == "flat":
			noise = enmap.rand_gauss_harm(self.shape, self.wcs, seed=seed, device=self.device)
			return enmap.samewcs(torch.sqrt(torch.clamp(_data(hprof).to(self.device), min=0))*noise.data, noise)
		return curvedsky.rand_alm(_host(hprof), lmax=self.lmax, seed=seed, device=self.device)
	def harm2powspec(self, harm, harm2=None, patch=False):
		"""The power spectrum of a harmonic object."""
		if self.mode == "flat":
			h1 = _data(harm)
			h2 = h1 if harm2 is None else _data(harm2)
			return enmap.samewcs((h1*torch.conj(h2)).real, harm)
		return curvedsky.alm2cl(torch.as_tensor(harm), None if harm2 is None else torch.as_tensor(harm2),
			ainfo=self.ainfo)
	def sum_hprof(self, hprof):
		"""The integral of an l-profile over all modes (summed on the
		profile's device where it is a tensor)."""
		if self.mode == "flat":
			# the sum over Fourier modes, int h d^2l/(2pi)^2 times 4 pi (so that
			# a caller's /(4 pi) gives the flat-sky mode integral)
			area = self.npix*enmap.pixsize(self.shape, self.wcs)
			if isinstance(hprof, (torch.Tensor, enmap.ndmap)): return float(_data(hprof).sum())*4*np.pi/area
			return _host(hprof).sum()*4*np.pi/area
		hprof = _host(hprof)
		l = np.arange(hprof.shape[-1])
		return np.sum(hprof*(2*l+1))/(4*np.pi)
	def lmap(self):
		if self.mode == "flat": return enmap.modlmap(self.shape, self.wcs, device=self.device)
		return self.l

class Dummy:
	def __init__(self, shape, wcs): self.shape, self.wcs = shape, wcs


def _data(x):
	"""x as a tensor: an ndmap's data, a tensor, or numpy data as a CPU tensor."""
	return x.data if isinstance(x, enmap.ndmap) else torch.as_tensor(x)

def _host(x):
	"""x as a numpy array (a tensor or an ndmap copied from its device)."""
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().cpu().numpy()
	return np.asarray(x)

def _aswcs(harm, uht):
	if isinstance(harm, enmap.ndmap): return harm
	return enmap.ndmap(torch.as_tensor(harm), uht.wcs)


def estimate_distortion(shape, wcs):
	"""The largest relative variation of the pixel scale over the map."""
	if wcsutils.is_plain(wcs): return 0.0
	dec1, dec2 = np.sort(np.asarray(enmap.corners(shape, wcs))[:, 0])
	dec1 = max(dec1, -np.pi/2); dec2 = min(dec2, np.pi/2)
	c1, c2 = np.cos(dec1), np.cos(dec2)
	cmax, cmin = max(c1, c2), min(c1, c2)
	if dec1 <= 0 <= dec2: cmax = 1.0
	if cmin <= 0: return np.inf
	return cmax/cmin - 1

def profile2harm_flat_2d(br, r, shape, wcs, *, device="cuda"):
	"""A radial real-space profile -> the 2D harmonic profile of a flat map:
	painted centred on pixel (0, 0) (cyclically) and Fourier transformed, so
	that B(l) has no phase; on device."""
	rmap = enmap.modrmap(shape, wcs, device=device).data
	prof = utils.interp(rmap, torch.as_tensor(np.asarray(r, float)).to(device),
		torch.as_tensor(np.asarray(br, float)).to(device), right=0.0)
	cy, cx = divmod(int(torch.argmin(rmap)), rmap.shape[-1])
	m = enmap.ndmap(torch.roll(prof, (-cy, -cx), (0, 1)), wcs)
	f = enmap.fft(m, normalize=False).real*enmap.pixsize(shape, wcs)
	return enmap.samewcs(f, m)

def harm2profile_flat_2d(hprof, r):
	"""A 2D Fourier-space profile -> the radial real-space profile at the
	radii r (numpy): inverse FFT, then the pixels sorted by radius and
	interpolated."""
	m = enmap.ifft(hprof, normalize=False).real
	pa = enmap.pixsize(hprof.shape, hprof.wcs)
	npix = np.prod(hprof.shape[-2:])
	b = _host(m)/npix/pa   # IFFT_norm / pixarea: the physical real-space beam
	rmap = enmap.modrmap(hprof.shape, hprof.wcs, device="cpu").data.numpy()
	cy, cx = np.unravel_index(rmap.argmin(), rmap.shape)
	b = np.roll(np.roll(b, -cy, -2), -cx, -1)
	rmap = np.roll(np.roll(rmap, -cy, -2), -cx, -1)
	order = np.argsort(rmap.reshape(-1))
	rs = rmap.reshape(-1)[order]
	bs = b.reshape(b.shape[:-2] + (-1,))[..., order]
	return np.interp(np.asarray(r), rs, bs if bs.ndim == 1 else bs[0])


def res2lmax(res):
	"""The lmax that resolves the scale res (radians)."""
	return utils.nint(np.pi/res)

def beam2res(br, r):
	"""A map resolution fitting the beam profile: a third of its fwhm."""
	br = np.asarray(br); r = np.asarray(r)
	fwhm = 2*r[np.where(br >= br[0]*0.5)[0][-1]]
	return fwhm/3

def beam2rmax(br, r, tol=1e-5, return_index=False):
	"""The radius beyond which the beam is below tol of its peak."""
	br = np.asarray(br); r = np.asarray(r)
	imax = np.where(br >= br[0]*tol)[0][-1]
	return (r[imax], imax) if return_index else r[imax]

def profile2harm_flat(br, r, oversample=2, pad_factor=2):
	"""The flat-sky approximation of curvedsky.profile2harm for a 1d
	profile (numpy [lmax+1]), on the host."""
	res = beam2res(br, r)
	rmax = beam2rmax(br, r)*pad_factor
	n = 2*utils.nint(rmax/res*oversample) + 1
	shape, wcs = enmap.geometry(pos=np.array([0, 0]), res=res/oversample, shape=(n, n), proj="car")
	lbeam_2d = profile2harm_flat_2d(br, r, shape, wcs, device="cpu")
	bl_tmp, l_tmp = enmap.lbin(lbeam_2d)
	lmax = res2lmax(res)
	l = np.arange(lmax + 1)
	return np.interp(l, _host(l_tmp), _host(bl_tmp))
