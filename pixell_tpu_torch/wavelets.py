"""Wavelet transforms on the sphere and the flat sky (counterpart of
pixell_tpu/wavelets.py).

A wavelet basis is a smooth partition of multipole space; the transform
synthesizes each filtered scale onto a geometry cut down to that scale's
bandlimit, so coarse scales are cheap, and returns a multimap.ndmaps. The
bases are host numpy. The transforms run on the map's device: in curved
mode the big alm is unfolded to its rectangular [nl, nm] view once, each
scale is a slice of it times its l-profile folded to the scale's layout,
the scales run in descending bandlimit, and wave2map accumulates in the
rectangular view and folds once.

offload=True keeps each scale's map on the CPU (moved there as soon as it
is made) and wave2map moves one scale at a time to the UHT's device
("cuda" unless told otherwise); None or False offloads nothing.
Not ported: the reference's automatic offload above OFFLOAD_BYTES and its
utils.fence calls, both workarounds for a 16 GB TPU behind a remote
runtime. mesh= (a DeviceMesh, parallel.mesh) runs every scale's SHT over
torch.distributed (uharm.UHT(mesh=)); under a mesh, offload=None resolves
to no offload, as in the reference (:222).
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, uharm, multimap, utils, wcsutils
from .parallel import mesh as pmesh


class Butterworth:
	"""Butterworth filter-bank basis (pixell_tpu.wavelets.Butterworth :12):
	scales logarithmically spaced by step, sharpness shape."""
	def __init__(self, step=2, shape=7, tol=1e-3, lmin=None, lmax=None):
		self.step, self.shape, self.tol = step, shape, tol
		self.lmin, self.lmax = lmin, lmax
	def with_bounds(self, lmin, lmax):
		return type(self)(step=self.step, shape=self.shape, tol=self.tol, lmin=lmin, lmax=lmax)
	@property
	def n(self):
		return int(np.ceil(np.log(self.lmax/max(self.lmin, 1))/np.log(self.step))) + 1
	def _knee(self, i):
		return self.lmin*self.step**i
	def kernel(self, i, l):
		l = np.asarray(l, float)
		def butter(l, knee):
			with np.errstate(divide="ignore"):
				return 1/(1 + (l/np.maximum(knee, 0.5))**self.shape)
		if i == 0:
			return np.sqrt(np.maximum(butter(l, self._knee(0)), 0))
		prof2 = butter(l, self._knee(i)) - butter(l, self._knee(i-1))
		# the last scale takes everything above
		if i == self.n-1:
			prof2 = 1 - butter(l, self._knee(i-1))
		return np.sqrt(np.maximum(prof2, 0))
	def __call__(self, i, l): return self.kernel(i, l)
	@property
	def lmaxs(self):
		"""The bandlimit of each scale: the l where its kernel falls to tol."""
		n = self.n
		shp = getattr(self, "shape", 7)
		lm = np.round(self.lmin*(1/max(self.tol, 1e-12) - 1)
			**(np.log(self.step)/shp)*self.step**(np.arange(n) + 0.5)).astype(int)
		lm = np.minimum(lm, self.lmax)
		lm[-1] = self.lmax
		return lm
	def get_variance_basis(self):
		"""The basis that maps white-noise variance as this one maps data."""
		return VarButter(step=self.step, shape=self.shape, tol=self.tol, lmin=self.lmin, lmax=self.lmax)

class ButterTrim(Butterworth):
	"""Butterworth basis trimmed to compact support (pixell_tpu.wavelets.
	ButterTrim :60): tails below tol are cut, so each scale has a hard
	bandlimit and a small geometry."""
	def kernel(self, i, l):
		prof = Butterworth.kernel(self, i, l)
		return np.where(prof**2 > self.tol, prof, 0.0)
	def lbounds(self, i):
		"""The [lmin, lmax] support of scale i."""
		l = np.arange(self.lmax+1)
		k = self.kernel(i, l)
		nz = np.where(k > 0)[0]
		if len(nz) == 0: return (0, 0)
		return int(nz[0]), int(nz[-1])

class DigitalButterTrim(ButterTrim):
	"""ButterTrim with the smooth kernels replaced by combs of top-hats whose
	cumulative sums track them, so that the scales are exactly orthogonal
	(pixell_tpu.wavelets.DigitalButterTrim :75)."""
	def _lowpass(self, i, l):
		"""The trimmed Butterworth low-pass kernel of scale i."""
		l = np.asarray(l, float)
		with np.errstate(divide="ignore"):
			k = 1/(1 + (l/np.maximum(self._knee(i), 0.5))**self.shape)
		return trim_kernel(k, self.tol)
	def _profiles(self):
		if getattr(self, "_prof_cache", None) is None:
			l = np.arange(self.lmax)
			ks = [np.zeros(l.size)]
			for i in range(self.n - 1):
				ks.append(digitize(self._lowpass(i, l)))
			ks.append(np.full(l.size, 1.0))
			ks = np.sort(np.array(ks), 0)
			self._prof_cache = ks[1:] - ks[:-1]  # 0/1: no sqrt needed
		return self._prof_cache
	def kernel(self, i, l):
		prof = self._profiles()[i]
		li = np.clip(np.asarray(l).astype(int), 0, prof.size - 1)
		return prof[li]
	def __call__(self, i, l): return self.kernel(i, l)
	def get_variance_basis(self):
		raise NotImplementedError

class CosineNeedlet:
	"""Cosine needlets (pixell_tpu.wavelets.CosineNeedlet :105): peaks at
	lpeaks, cosine interpolation between neighbours."""
	def __init__(self, lpeaks=None, lmin=None, lmax=None):
		self.lpeaks = None if lpeaks is None else np.asarray(lpeaks)
		self.lmin, self.lmax = lmin, lmax
	def with_bounds(self, lmin, lmax):
		lpeaks = self.lpeaks
		if lpeaks is None:
			peaks = [lmin]
			while peaks[-1] < lmax:
				peaks.append(min(int(np.ceil(peaks[-1]*2)), lmax))
			lpeaks = np.array(peaks)
		return CosineNeedlet(lpeaks=lpeaks, lmin=lmin, lmax=lmax)
	@property
	def n(self): return len(self.lpeaks)
	def kernel(self, i, l):
		l = np.asarray(l, float)
		lp = self.lpeaks
		res = np.zeros_like(l)
		p = lp[i]
		if i > 0:
			lo = lp[i-1]
			m = (l >= lo) & (l < p)
			res[m] = np.cos(np.pi/2*(p - l[m])/(p - lo))
		res[l == p] = 1
		if i < self.n-1:
			hi = lp[i+1]
			m = (l > p) & (l <= hi)
			res[m] = np.cos(np.pi/2*(l[m] - p)/(hi - p))
		if i == 0:
			res[l <= p] = 1
		if i == self.n-1:
			res[l >= p] = 1
		return res
	def lbounds(self, i):
		lo = self.lpeaks[i-1] if i > 0 else 0
		hi = self.lpeaks[i+1] if i < self.n-1 else self.lmax
		return int(lo), int(hi)
	def __call__(self, i, l): return self.kernel(i, l)




class WaveletTransform:
	"""Map -> wavelet-coefficient maps and back, each scale on a geometry cut
	down to its bandlimit (pixell_tpu.wavelets.WaveletTransform :158).
	offload=True keeps the scales' maps on the CPU; wave2map moves them to
	the UHT's device. device is that of the UHT made from a geometry."""
	def __init__(self, uht_or_geo, basis=None, ores=None, mesh=None, offload=None, *, device="cuda"):
		mesh = pmesh.check(mesh)
		if isinstance(uht_or_geo, uharm.UHT):
			self.uht = uht_or_geo
			if mesh is not None: self.uht.mesh = mesh
		else:
			shape, wcs = uht_or_geo
			self.uht = uharm.UHT(shape, wcs, mesh=mesh, device=device)
		self.mesh = mesh
		self.offload = False if (offload is None and mesh is not None) else offload
		shape, wcs = self.uht.shape, self.uht.wcs
		if basis is None: basis = ButterTrim()
		lmax = self.uht.lmax
		lmin = max(int(np.ceil(np.pi/max(_patch_size(shape, wcs), 1e-10))), 1)
		if getattr(basis, "lmax", None) is None or getattr(basis, "lmin", None) is None:
			basis = basis.with_bounds(lmin, lmax)
		self.basis = basis
		self.geometries = []
		self.uhts = []
		ires = float(np.max(np.asarray(enmap.pixshapebounds(shape, wcs)))) if self.uht.mode == "curved" else None
		for i in range(basis.n):
			lo, hi = basis.lbounds(i) if hasattr(basis, "lbounds") else (0, lmax)
			hi_eff = min(hi if hi > 0 else lmax, lmax)
			if self.uht.mode == "curved":
				# a fresh full-sky-compatible geometry at ~pi/hi: hi + 4 keeps
				# nt >= hi + 1 rings and nphi >= 2 hi + 1 columns, so that the
				# scale's analysis is exact
				ores = max(np.pi/(hi_eff + 4), ires)
				ogeo = make_wavelet_geometry_curved(shape, wcs, ores)
			else:
				ogeo = make_wavelet_geometry(shape, wcs, hi)
			self.geometries.append(ogeo)
			self.uhts.append(uharm.UHT(ogeo[0], ogeo[1], mode=self.uht.mode, lmax=hi_eff,
				mesh=mesh, device=self.uht.device))
	@property
	def nlevel(self): return self.basis.n
	@property
	def shape(self): return self.uht.shape
	@property
	def wcs(self): return self.uht.wcs
	@property
	def geometry(self): return self.shape, self.wcs
	def get_ls(self, i):
		"""The multipoles of scale i: a map of |l| in flat mode (on the UHT's
		device), [lmax+1] in curved mode."""
		return self.uhts[i].lmap()
	def get_variance_transform(self):
		"""The WaveletTransform that maps white-noise variance maps as this
		one maps data."""
		return WaveletTransform(self.uht, basis=self.basis.get_variance_basis())
	def _flat_kernel(self, i, like):
		"""Scale i's kernel on the full flat geometry, in like's real dtype on
		its device (the basis is host numpy)."""
		l2 = enmap.modlmap(self.uht.shape, self.uht.wcs, device="cpu").data.numpy()
		return torch.from_numpy(self.basis.kernel(i, l2)).to(like.device, utils.real_dtype(like.dtype))
	def map2wave(self, map, owave=None):
		"""The map decomposed into wavelet maps (an ndmaps, in basis order),
		the scales computed in descending bandlimit: the largest synthesis
		peaks before the other scales' outputs are held. Curved mode slices
		each scale from the big alm's rectangular [nl, nm] view."""
		harm = self.uht.map2harm(map, spin=0)
		outs = [None]*self.basis.n
		rect = self.uht.ainfo._rect(harm) if self.uht.mode == "curved" else None
		for i in reversed(range(self.basis.n)):
			u = self.uhts[i]
			prof = self.basis.kernel(i, np.arange(u.lmax+1, dtype=float))
			if rect is not None:
				L, M = u.ainfo.lmax+1, u.ainfo.mmax+1
				pf = torch.from_numpy(np.asarray(prof, np.float64)).to(rect.device, rect.real.dtype)
				sub = u.ainfo._unrect(rect[..., :L, :M]*pf[:L, None])
				m = u.harm2map(sub, spin=0)
				del sub
			else:
				# flat: filter in 2D Fourier space, then resample
				filt = enmap.samewcs(harm.data*self._flat_kernel(i, harm.data), map)
				full = enmap.harm2map(filt, spin=[0]).real
				m = full.project(u.shape, u.wcs, order=3) if u.shape != self.uht.shape else full
			if self.offload:
				m = enmap.ndmap(m.data.cpu(), m.wcs)
			outs[i] = m
		return multimap.ndmaps(outs)
	def wave2map(self, wave, omap=None):
		"""The map reassembled from its wavelet maps (on their device, or
		moved one at a time from the CPU to the UHT's device where they were
		offloaded). Curved mode accumulates the scales in the
		rectangular [nl, nm] view and folds to the triangular layout once."""
		curved = self.uht.mode == "curved"
		total = None
		for i in range(self.basis.n):
			u = self.uhts[i]
			m = wave.maps[i]
			if self.offload: m = enmap.ndmap(m.data.to(self.uht.device), m.wcs)
			prof = self.basis.kernel(i, np.arange(u.lmax+1, dtype=float))
			if curved:
				srect = u.ainfo._rect(u.map2harm(m, spin=0))
				pf = torch.from_numpy(np.asarray(prof, np.float64)).to(srect.device, srect.real.dtype)
				srect = srect*pf[:srect.shape[-2], None]
				if total is None:
					total = torch.zeros(srect.shape[:-2] + (self.uht.ainfo.lmax+1, self.uht.ainfo.mmax+1),
						dtype=srect.dtype, device=srect.device)
				L, M = srect.shape[-2:]
				total[..., :L, :M] += srect
				del srect
			else:
				h = enmap.map2harm(m.project(self.uht.shape, self.uht.wcs, order=3)
					if m.shape[-2:] != tuple(self.uht.shape) else m, spin=[0])
				big = h.data*self._flat_kernel(i, h.data)
				total = big if total is None else total + big
		if curved and total is not None:
			total = self.uht.ainfo._unrect(total)
		res = self.uht.harm2map(total, spin=0)
		return res.real if res.dtype.is_complex else res


class HaarTransform:
	"""Haar wavelets by down- and upgrades (pixell_tpu.wavelets.HaarTransform :344)."""
	def __init__(self, nlevel=None):
		self.nlevel = nlevel
	def map2wave(self, map):
		nlevel = self.nlevel
		if nlevel is None:
			nlevel = int(np.log2(min(map.shape[-2:]))) - 1
		outs = []
		cur = map
		for i in range(nlevel):
			down = enmap.downgrade(cur, 2)
			up = enmap.upgrade(down, 2, oshape=cur.shape)
			outs.append(cur - up)
			cur = down
		outs.append(cur)
		return multimap.ndmaps(outs)
	def wave2map(self, wave):
		cur = wave.maps[-1]
		for det in wave.maps[-2::-1]:
			cur = enmap.upgrade(cur, 2, oshape=det.shape) + det
		return cur


def _patch_size(shape, wcs):
	ext = enmap.extent(shape, wcs)
	return float(np.max(np.asarray(ext)))

def make_wavelet_geometry(shape, wcs, lmax_scale, margin=4):
	"""A geometry with just enough resolution for multipoles up to
	lmax_scale: the input downgraded by a power of two that divides its
	pixel counts (so that full-sky F1 / CC grids stay quadrature-exact)."""
	if lmax_scale <= 0: return tuple(shape[-2:]), wcs
	ires = min(abs(wcs.wcs.cdelt[0]), abs(wcs.wcs.cdelt[1]))*utils.degree
	ores = np.pi/(lmax_scale + margin)
	factor = max(int(np.floor(ores/ires)), 1)
	factor = 2**int(np.log2(factor)) if factor > 1 else 1
	while factor > 1 and (shape[-2] % factor or shape[-1] % factor):
		factor //= 2
	if factor == 1: return tuple(shape[-2:]), wcs
	oshape, owcs = enmap.downgrade_geometry(shape, wcs, factor)
	return tuple(oshape[-2:]), owcs


class AdriSD:
	"""Scale-discrete wavelets (pixell_tpu.wavelets.AdriSD :390): cosine
	needlets on peaks spaced by lamb, compactly supported, squaring to one."""
	def __init__(self, lamb=2.0, lmin=None, lmax=None):
		self.lamb = lamb
		self.lmin, self.lmax = lmin, lmax
		self._cn = None
	def with_bounds(self, lmin, lmax):
		res = AdriSD(self.lamb, lmin, lmax)
		peaks = [max(lmin, 1)]
		while peaks[-1] < lmax:
			peaks.append(min(int(np.ceil(peaks[-1]*self.lamb)), lmax))
		res._cn = CosineNeedlet(lpeaks=np.array(peaks), lmin=lmin, lmax=lmax)
		return res
	@property
	def n(self): return self._cn.n
	@property
	def lmaxs(self):
		return np.array([self.lbounds(i)[1] for i in range(self.n)])
	def kernel(self, i, l): return self._cn.kernel(i, l)
	def lbounds(self, i): return self._cn.lbounds(i)
	def __call__(self, i, l): return self.kernel(i, l)
	def get_variance_basis(self):
		raise NotImplementedError


class VarButter:
	"""The variance basis of Butterworth wavelets (pixell_tpu.wavelets.
	VarButter :418): how white-noise variance maps through each scale, |F|^2
	convolved with itself in real space by a radial Hankel transform,
	F2(l) = H[H^-1[F](r)^2](l)."""
	def __init__(self, step=2, shape=7, tol=1e-3, lmin=None, lmax=None):
		self.step = step; self.shape = shape; self.tol = tol
		self.lmin = lmin; self.lmax = lmax
		self.basis = None
		if self.lmin is not None and self.lmax is not None:
			self._finalize()
	@property
	def n(self): return self.basis.n
	@property
	def lmaxs(self): return self.basis.lmaxs
	def with_bounds(self, lmin, lmax):
		return VarButter(step=self.step, shape=self.shape, tol=self.tol, lmin=lmin, lmax=lmax)
	def __call__(self, i, l):
		return np.interp(np.asarray(l, float), self.l, self.kernels[i])
	def kernel(self, i, l): return self(i, l)
	def lbounds(self, i):
		return self.basis.lbounds(i) if hasattr(self.basis, "lbounds") else (0, int(self.basis.lmaxs[i]))
	def _kernel_helper(self, i, rft):
		if i < self.basis.n - 1:
			F = self.basis(i, rft.l)
		else:
			# the last scale bounded at lmax, not to sum power that is absent
			kernel = 1/(1 + (rft.l/self.basis.lmax)**(self.basis.shape/np.log(self.basis.step)))
			prev = 1/(1 + (rft.l/(self.basis.lmin*self.basis.step**(i - 0.5)))
				**(self.basis.shape/np.log(self.basis.step)))
			F = np.sqrt(np.maximum(kernel - prev, 0))
		F2 = rft.real2harm(rft.harm2real(F)**2)
		return rft.unpad(F2)
	def _finalize(self):
		self.basis = Butterworth(step=self.step, shape=self.shape, tol=self.tol, lmin=self.lmin, lmax=self.lmax)
		rft = utils.RadialFourierTransform()
		self.kernels = [self._kernel_helper(i, rft) for i in range(self.n)]
		self.l = rft.unpad(rft.l)


def trim_kernel(a, tol):
	return np.clip(np.asarray(a)*(1 + 2*tol) - tol, 0, 1)

def digitize(a):
	"""An on/off array whose cumulative sum tracks the smooth 0..1 array a."""
	f = np.round(np.cumsum(np.asarray(a)))
	return np.concatenate([[1], (f[1:] != f[:-1]).astype(int)])

def make_wavelet_geometry_flat(ishape, iwcs, ires, ores, margin=4):
	"""The downgraded flat geometry of a wavelet scale."""
	oshape = np.ceil(np.array(ishape[-2:])*ires/ores).astype(int) + margin
	oshape = np.minimum(oshape, ishape[-2:])
	owcs = wcsutils.scale(iwcs, oshape[-2:]/np.array(ishape[-2:]), rowmajor=True, corner=True)
	return tuple(oshape), owcs

def make_wavelet_geometry_curved(ishape, iwcs, ores, minres=2*np.pi/180*2):
	"""A full-sky-compatible geometry at resolution ores covering the input
	patch, its ring count raised to the next 2357-smooth column count (fast
	ring FFTs)."""
	from . import fft as enfft
	N = max(int(np.ceil(np.pi/ores)), int(np.ceil(np.pi/minres)))
	while enfft.fft_len(2*N, "above") != 2*N:
		N += 1
	res = np.pi/N
	box = np.array(enmap.corners(ishape, iwcs))
	box[:, 0] = np.clip(box[:, 0], -np.pi/2, np.pi/2)
	box[1, 1] = box[0, 1] + np.clip(box[1, 1] - box[0, 1], -2*np.pi, 2*np.pi)
	tshape, twcs = enmap.fullsky_geometry(res=res)
	pbox = np.asarray(enmap.skybox2pixbox(tshape, twcs, box))
	pbox[np.argmax(pbox[:, 0]), 0] += 1
	pbox = utils.nint(pbox)
	# y ascending and clamped to the sphere (a full-sky input's corners fall
	# on pixel edges of the target grid, and the +1 above could add a ring
	# past the pole); x at its full, possibly wrapped, width from the left
	# edge
	y1 = max(int(min(pbox[:, 0])), 0)
	y2 = min(int(max(pbox[:, 0])), int(tshape[-2]))
	wx = min(int(utils.nint(abs(box[1, 1] - box[0, 1])/(2*np.pi)*tshape[-1])), tshape[-1])
	# a full-wrap input's corner ra difference rewinds to 0: detect it by cdelt
	if wx == 0 and abs(ishape[-1]*iwcs.wcs.cdelt[0]) >= 360 - 1e-6:
		wx = tshape[-1]
	x1 = int(utils.rewind(min(pbox[:, 1]), ref=tshape[-1]//2, period=tshape[-1]))
	return enmap.slice_geometry(tshape, twcs, (slice(y1, y2), slice(x1, x1 + wx)), nowrap=True)
