"""Constants and small helpers (counterpart of pixell_tpu/utils.py).

Only what the ported modules call: the angle constants, the physical
constants T_cmb, c, h and k (aberration's Doppler modulation), nint,
rewind/unwind for the pixel<->sky conversions, eigpow for rand_alm,
spec2flat and array_ops, the Minres solver of curvedsky.minres_inverse
and the CG solver that checkpoint saves and resumes (on tensors),
and for the flat sky split_slice / expand_slice (ndmap indexing), nditer,
real_dtype / complex_dtype (numpy or torch dtypes), ang2rect / rect2ang /
angdist (modrmap, extent's subgrid) and rotmatrix (coordinates' Euler
matrices); rewind also takes tensors; interp is np.interp on tensors. For the pixel boxes of enmap's
extract family: the slice-box algebra (sbox_*) and parse_slice, host numpy;
for its resolution changes: block_reduce / block_expand and downgrade /
upgrade, which work on tensors (on their device) as well as numpy arrays.
eigpow too takes either. czeros makes zeros on a device; for
the wavelets' variance basis, RadialFourierTransform (scipy's FFTLog
Hankel transform, host numpy); for the catalogues, crossmatch (scipy's
k-d tree). The rest is numpy: geometry, random draws and that solver's
vectors are host work. For the distance, analysis and ephemeris slice: fwhm and AU, the time
conversions ctime2mjd / mjd2ctime / ctime2djd, widen_box,
find_equal_groups / find_equal_groups_fast and calc_beam_area (host
numpy). For the communicators (parallel.dist, mpi): allreduce, allgather,
allgatherv, send and recv, host numpy over any communicator. Not ported: fence and to_device's complex split,
which worked around a remote TPU runtime; a tensor's own .to() does their
work.
"""
from __future__ import annotations
import numpy as np
import torch

# ---------------------------------------------------------------------------
# Constants (pixell_tpu/utils.py:17-60), the same values: SI units, angles in
# radians
# ---------------------------------------------------------------------------
degree  = np.pi/180
arcmin  = degree/60
arcsec  = arcmin/60
fwhm    = 1.0/(8*np.log(2))**0.5   # sigma per FWHM
T_cmb   = 2.7255
c       = 299792458.0
h       = 6.62607004e-34
k       = 1.38064853e-23
e       = 1.60217662e-19
G       = 6.67430e-11
sb      = 5.670374419e-8
day2sec = 86400.
yr2days = 365.2422
minute  = 60.
hour    = 3600.
day     = 24*hour
yr      = yr2days*day
ly      = c*yr
AU      = 149597870700.0
pc      = AU/arcsec
Jy      = 1e-26
hbar    = h/(2*np.pi)
sigma_T  = 6.6524587158e-29
sigma_sb = sb
m_e     = 9.1093837015e-31
m_p     = 1.6726219237e-27
m_n     = 1.6749274980e-27
# radii, masses and orbit radii of the solar system's bodies
R_sun     = 695700e3  ; M_sun     = 1.9885e30   ; r_sun     =  29e3*ly; L_sun = 3.827e26
R_mercury = 2439.5e3  ; M_mercury = 0.330e24    ; r_mercury =  57.9e9
R_venus   = 6052e3    ; M_venus   = 4.87e24     ; r_venus   = 108.2e9
R_earth   = 6378.1e3  ; M_earth   = 5.9722e24   ; r_earth   = 149.6e9
R_moon    = 1737.5e3  ; M_moon    = 0.073e24    ; r_moon    =   0.384e9
R_mars    = 3396e3    ; M_mars    = 0.642e24    ; r_mars    = 227.9e9
R_jupiter = 71492e3   ; M_jupiter = 1898e24     ; r_jupiter = 778.6e9
R_saturn  = 60268e3   ; M_saturn  = 568e24      ; r_saturn  = 1433.5e9
R_uranus  = 25559e3   ; M_uranus  = 86.8e24     ; r_uranus  = 2872.5e9
R_neptune = 24764e3   ; M_neptune = 102e24      ; r_neptune = 4495.1e9
R_pluto   = 1185e3    ; M_pluto   = 0.0146e24   ; r_pluto   = 5906.4e9
r_l1 = R_earth - 1.4916e9
r_L2 = R_earth + 1.5016e9
# the units as 0-d arrays, which coerce what they multiply to arrays
a    = np.array(1.0)
adeg = np.array(degree)
amin = np.array(arcmin)
asec = np.array(arcsec)


def nint(a):
	"""Round to nearest integer, returning int dtype (pixell_tpu.utils.nint)."""
	return np.round(a).astype(int)


def rewind(a, ref=0, period=2*np.pi):
	"""Map angles into (ref-period/2, ref+period/2] (pixell_tpu.utils.rewind);
	a tensor on its device, anything else as numpy."""
	if not isinstance(a, torch.Tensor): a = np.asarray(a)
	if isinstance(ref, str) and ref == "auto":
		flat = a.reshape(-1)
		ref = (torch.sort(flat)[0] if isinstance(a, torch.Tensor) else np.sort(flat))[flat.shape[0]//2]
	return ref + (a - ref + period/2) % period - period/2


def unwind(a, period=2*np.pi, axes=[-1], ref=None, refmode="left", mask_nan=False):
	"""Remove period jumps along axes so the result is continuous
	(pixell_tpu.utils.unwind; mask_nan is accepted and ignored, as there)."""
	a = np.asarray(a).astype(float)
	for ax in axes:
		a = np.moveaxis(a, ax, -1)
		diffs = (np.diff(a, axis=-1) + period/2) % period - period/2
		first = a[..., :1]
		if refmode == "middle":
			first = rewind(first, 0, period)
		a = np.concatenate([first, first + np.cumsum(diffs, axis=-1)], -1)
		a = np.moveaxis(a, -1, ax)
	if ref is not None:
		a = a - period*np.round((a.reshape(-1)[0] - ref)/period)
	return a


def eigpow(A, e, axes=[-2, -1], rlim=None, alim=None):
	"""Raise a (stack of) symmetric matrices to the power e via
	eigen-decomposition (pixell_tpu.utils.eigpow). Negative eigenvalues are
	zeroed for non-integer e; tiny ones (rlim relative, alim absolute) are
	zeroed for e < 0. One code for both kinds of input, as the reference's
	for numpy and jnp: a tensor is raised in torch on its device, anything
	else in numpy, which keeps numpy input bit for bit the reference's
	(rand_alm's draws depend on it)."""
	xp = torch if isinstance(A, torch.Tensor) else np
	A = xp.asarray(A)
	ax1, ax2 = axes[0] % A.ndim, axes[1] % A.ndim
	A = xp.moveaxis(A, (ax1, ax2), (-2, -1))
	E, V = xp.linalg.eigh(A)
	fi = xp.finfo(E.dtype)
	if rlim is None: rlim = fi.resolution*100
	if alim is None: alim = fi.tiny*1e4
	is_int = float(e) == int(e)
	mask = xp.zeros_like(E, dtype=bool)
	if not is_int: mask = mask | (E < 0)
	if e < 0:
		aE = xp.abs(E)
		mask = mask | (aE < xp.amax(aE, -1, keepdims=True)*rlim) | (aE < alim)
	sgn = xp.where(E < 0, (-1.0)**int(e) if is_int else 1.0, 1.0)
	Ez = xp.where(mask, 1.0, xp.abs(E))
	Ep = xp.where(mask, 0.0, sgn*Ez**e)
	res = xp.einsum("...ij,...j,...kj->...ik", V, Ep, V)
	return xp.moveaxis(res, (-2, -1), (ax1, ax2))


def _vdot(a, b):
	"""Re sum(conj(a) b) as a Python float, for tensors (on their device) or numpy."""
	if isinstance(a, torch.Tensor): return float(torch.sum(a.conj()*b).real)
	return float(np.sum(np.conj(np.asarray(a))*np.asarray(b)).real)


def _copy(a):
	return a.clone() if isinstance(a, torch.Tensor) else np.array(a)


class CG:
	"""Preconditioned conjugate gradients for A x = b, A (and the
	preconditioner M) a callable (pixell_tpu.utils.CG :620): tensors stay on
	their device, numpy arrays on the host. step() improves x; err is rz/rz0.
	save / load keep x, r, p, rz, rz0 and i in an HDF5 file, so that a run
	stopped and resumed gives the iterates of one run uninterrupted."""
	def __init__(self, A, b, x0=None, M=lambda x: x, dot=None):
		self.A = A; self.M = M
		self.b = b
		self.dot = _vdot if dot is None else dot
		if x0 is None:
			self.x = torch.zeros_like(b) if isinstance(b, torch.Tensor) else np.zeros_like(np.asarray(b))
			self.r = _copy(b)
		else:
			self.x = x0
			self.r = b - self.A(self.x)
		self.z  = self.M(self.r)
		self.rz = self.dot(self.r, self.z)
		self.rz0 = float(self.rz)
		self.p  = self.z
		self.i  = 0
		self.err = np.inf
	def step(self):
		Ap = self.A(self.p)
		alpha = self.rz/self.dot(self.p, Ap)
		self.x = self.x + alpha*self.p
		self.r = self.r - alpha*Ap
		self.z = self.M(self.r)
		next_rz = self.dot(self.r, self.z)
		beta = next_rz/self.rz
		self.rz = next_rz
		self.p = self.z + beta*self.p
		self.i += 1
		self.err = self.rz/self.rz0
		return self.x
	def save(self, fname):
		import h5py
		host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
		with h5py.File(fname, "w") as f:
			f["x"] = host(self.x); f["r"] = host(self.r)
			f["p"] = host(self.p); f["rz"] = self.rz
			f["rz0"] = self.rz0; f["i"] = self.i
	def load(self, fname):
		import h5py
		back = (lambda a: torch.from_numpy(a).to(self.b.device)) if isinstance(self.b, torch.Tensor) else \
			(lambda a: a)
		with h5py.File(fname, "r") as f:
			self.x = back(f["x"][()]); self.r = back(f["r"][()]); self.p = back(f["p"][()])
			self.rz = float(f["rz"][()]); self.rz0 = float(f["rz0"][()])
			self.i = int(f["i"][()])
			self.z = self.M(self.r)


class Minres:
	"""Minimum-residual solver for a symmetric, possibly indefinite, linear
	operator A on numpy vectors (pixell_tpu.utils.Minres :665): step()
	improves x; err is |r|/|b|."""
	def __init__(self, A, b, x0=None, dot=None):
		self.A = A
		if dot is None:
			dot = lambda a, b: float(np.sum(np.conj(np.asarray(a))*np.asarray(b)).real)
		self.dot = dot
		self.b = np.asarray(b)
		self.x = np.zeros_like(self.b) if x0 is None else np.asarray(x0).copy()
		self.r = self.b - A(self.x) if x0 is not None else self.b.copy()
		self.p0 = self.r.copy()
		self.s0 = A(self.p0)
		self.p1 = None; self.s1 = None
		self.i = 0
		self.bnorm = self.dot(self.b, self.b)**0.5
		self.err = 1.0
	def step(self):
		ss = self.dot(self.s0, self.s0)
		alpha = self.dot(self.r, self.s0)/ss
		self.x = self.x + alpha*self.p0
		self.r = self.r - alpha*self.s0
		p2, s2 = self.p1, self.s1
		self.p1, self.s1 = self.p0, self.s0
		p0 = self.s1.copy()
		s0 = self.A(p0)
		beta1 = self.dot(s0, self.s1)/ss
		p0 = p0 - beta1*self.p1
		s0 = s0 - beta1*self.s1
		if p2 is not None:
			ss2 = self.dot(s2, s2)
			beta2 = self.dot(self.A(self.s1), s2)/ss2
			p0 = p0 - beta2*p2
			s0 = s0 - beta2*s2
		self.p0, self.s0 = p0, s0
		self.i += 1
		self.err = self.dot(self.r, self.r)**0.5/max(self.bnorm, 1e-300)
		return self.x


# ---------------------------------------------------------------------------
# Slices, iteration and dtypes (pixell_tpu/utils.py:489-610)
# ---------------------------------------------------------------------------
def split_slice(sel, ndims):
	"""Split a selection tuple into groups covering ndims[0], ndims[1], ...
	dimensions each, Ellipsis expanded (pixell_tpu.utils.split_slice)."""
	if not isinstance(sel, tuple): sel = (sel,)
	ntot = sum(ndims)
	if Ellipsis in sel:
		i = sel.index(Ellipsis)
		ncur = len([s for s in sel if s is not Ellipsis and s is not None])
		sel = sel[:i] + (slice(None),)*(ntot-ncur) + sel[i+1:]
	res, i = [], 0
	for nd in ndims:
		group = []
		while i < len(sel) and len([g for g in group if g is not None]) < nd:
			group.append(sel[i]); i += 1
		res.append(tuple(group))
	if i < len(sel): res[-1] = res[-1] + sel[i:]
	return res


def expand_slice(sel, n, nowrap=False):
	"""sel with explicit start, stop and step for length n
	(pixell_tpu.utils.expand_slice)."""
	return slice(*sel.indices(n))


def nditer(shape):
	"""Every index tuple of shape, () for an empty one (pixell_tpu.utils.nditer)."""
	if len(shape) == 0:
		yield ()
		return
	yield from np.ndindex(*shape)


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}

def real_dtype(dtype):
	"""The real dtype of a possibly complex numpy or torch dtype."""
	if isinstance(dtype, torch.dtype): return _REAL.get(dtype, dtype)
	return np.zeros(1, dtype).real.dtype


def complex_dtype(dtype):
	"""The complex dtype of a possibly real numpy or torch dtype (at least
	complex64, as pixell_tpu.utils.complex_dtype)."""
	if isinstance(dtype, torch.dtype):
		return dtype if dtype.is_complex else _COMPLEX.get(dtype, torch.complex64)
	return np.result_type(dtype, np.complex64)


# ---------------------------------------------------------------------------
# Coordinate geometry (pixell_tpu/utils.py:222-258)
# ---------------------------------------------------------------------------
def ang2rect(angs, zenith=False, axis=0):
	"""[{phi, theta}, ...] angles -> [{x, y, z}, ...] unit vectors; theta
	is the latitude, or with zenith the colatitude."""
	phi, theta = np.moveaxis(np.asarray(angs), axis, 0)
	st, ct = np.sin(theta), np.cos(theta)
	if zenith: res = np.stack([st*np.cos(phi), st*np.sin(phi), ct])
	else:      res = np.stack([ct*np.cos(phi), ct*np.sin(phi), st])
	return np.moveaxis(res, 0, axis)


def rect2ang(rect, zenith=False, axis=0):
	"""The inverse of ang2rect."""
	x, y, z = np.moveaxis(np.asarray(rect), axis, 0)
	r = np.sqrt(x*x + y*y)
	theta = np.arctan2(r, z) if zenith else np.arctan2(z, r)
	return np.moveaxis(np.stack([np.arctan2(y, x), theta]), 0, axis)


def angdist(a, b, zenith=False, axis=0):
	"""The angle between [{ra, dec}, ...] points a and b, in radians, by
	Vincenty's formula (robust at small separations)."""
	ra1, dec1 = np.moveaxis(np.asarray(a), axis, 0)
	ra2, dec2 = np.moveaxis(np.asarray(b), axis, 0)
	if zenith: dec1, dec2 = np.pi/2 - dec1, np.pi/2 - dec2
	dra = ra2 - ra1
	y = np.hypot(np.cos(dec2)*np.sin(dra),
		np.cos(dec1)*np.sin(dec2) - np.sin(dec1)*np.cos(dec2)*np.cos(dra))
	x = np.sin(dec1)*np.sin(dec2) + np.cos(dec1)*np.cos(dec2)*np.cos(dra)
	return np.arctan2(y, x)


def rotmatrix(ang, raxis, xp=np):
	"""The rotation matrix [..., 3, 3] by ang about axis "x", "y" or "z"
	(pixell_tpu.utils.rotmatrix): numpy float64, or with xp=torch a tensor
	on ang's device."""
	ang = xp.asarray(ang)
	c_, s_ = xp.cos(ang), xp.sin(ang)
	one, zero = xp.ones_like(c_), xp.zeros_like(c_)
	raxis = raxis.lower()
	if   raxis == "x": rows = [[one, zero, zero], [zero, c_, -s_], [zero, s_, c_]]
	elif raxis == "y": rows = [[c_, zero, s_], [zero, one, zero], [-s_, zero, c_]]
	elif raxis == "z": rows = [[c_, -s_, zero], [s_, c_, zero], [zero, zero, one]]
	else: raise ValueError("Rotation axis %s not recognized" % raxis)
	return xp.stack([xp.stack(r, -1) for r in rows], -2)


def interp(x, xp_, fp, *, left=None, right=None):
	"""np.interp(x, xp_, fp, left, right) (pixell_tpu.utils.interp): for a
	tensor x on its device (xp_ and fp float tensors there): fp[0] (or left)
	below xp_[0], fp[-1] (or right) above xp_[-1], linear between, as numpy
	computes it (the slope of the interval times the offset into it, plus
	its left value); anything else by numpy."""
	if not isinstance(x, torch.Tensor): return np.interp(x, xp_, fp, left, right)
	xp = xp_
	j = (torch.searchsorted(xp, x.contiguous(), right=True) - 1).clamp(0, xp.shape[0] - 2)
	res = (fp[j+1] - fp[j])/(xp[j+1] - xp[j])*(x - xp[j]) + fp[j]
	res = torch.where(x == xp[-1], fp[-1], res)
	res = torch.where(x < xp[0], fp[0] if left is None else left, res)
	return torch.where(x > xp[-1], fp[-1] if right is None else right, res)


def moveaxis(a, o, n):
	"""a with axis o moved to n (pixell_tpu.utils.moveaxis), a tensor by torch."""
	return torch.movedim(a, o, n) if isinstance(a, torch.Tensor) else np.moveaxis(a, o, n)


def parse_slice(desc):
	"""A selection written as a string, like '[0,:10,::2]', as a tuple
	(pixell_tpu.utils.parse_slice)."""
	if desc is None: return None
	class Foo:
		def __getitem__(self, s): return s
	s = eval("Foo()" + desc, {"Foo": Foo})
	if not isinstance(s, tuple): s = (s,)
	return s


# ---------------------------------------------------------------------------
# Block reduce / expand and downgrade / upgrade (pixell_tpu/utils.py:278-300,
# :2138-2160): tensors stay on their device, numpy stays numpy
# ---------------------------------------------------------------------------
def _cat(xs, axis):
	return torch.cat(xs, axis) if isinstance(xs[0], torch.Tensor) else np.concatenate(xs, axis)


def _repeat(a, n, axis):
	return torch.repeat_interleave(a, n, axis) if isinstance(a, torch.Tensor) else np.repeat(a, n, axis)


def block_reduce(a, bsize, axis=-1, off=0, op=None, inclusive=True):
	"""a reduced by a factor bsize along axis by op (default the mean; a
	callable taking (array, axis=-1)); with inclusive, a partial last block
	makes one more output (pixell_tpu.utils.block_reduce)."""
	if not isinstance(a, torch.Tensor): a = np.asarray(a)
	if op is None: op = torch.mean if isinstance(a, torch.Tensor) else np.mean
	a = moveaxis(a, axis, -1)
	n = a.shape[-1]
	nfull = (n - off)//bsize
	nb = (n - off + bsize - 1)//bsize if inclusive else nfull
	res = op(a[..., off:off+nfull*bsize].reshape(a.shape[:-1] + (nfull, bsize)), axis=-1)
	if inclusive and nb > nfull:
		res = _cat([res, op(a[..., off+nfull*bsize:], axis=-1)[..., None]], -1)
	return moveaxis(res, -1, axis)


def block_expand(a, bsize, osize=None, axis=-1, off=0, op="nearest"):
	"""The inverse of block_reduce: each value repeated bsize times along
	axis, cut to osize, the first repeated off more times in front
	(pixell_tpu.utils.block_expand)."""
	if not isinstance(a, torch.Tensor): a = np.asarray(a)
	a = moveaxis(a, axis, -1)
	if osize is None: osize = a.shape[-1]*bsize + off
	res = _repeat(a, bsize, -1)[..., :osize-off]
	if off: res = _cat([_repeat(a[..., :1], off, -1), res], -1)
	return moveaxis(res, -1, axis)


def downgrade(arr, down, axes=None, op=None, inclusive=True):
	"""arr reduced by integer factors down along axes (the last ones by
	default) by op, the mean unless given (pixell_tpu.utils.downgrade)."""
	downs = np.atleast_1d(down)
	if axes is None: axes = range(-len(downs), 0)
	for d, ax in zip(downs, np.atleast_1d(axes)):
		arr = block_reduce(arr, int(d), axis=int(ax), op=op, inclusive=inclusive)
	return arr


def upgrade(arr, factor, axes=None, oshape=None, inclusive=True):
	"""arr with each value repeated by integer factors along axes, cut to
	oshape where given (pixell_tpu.utils.upgrade)."""
	if not isinstance(arr, torch.Tensor): arr = np.asarray(arr)
	factors = np.atleast_1d(factor)
	if axes is None: axes = range(-len(factors), 0)
	for f, ax in zip(factors, np.atleast_1d(axes)):
		ax = int(ax)
		arr = _repeat(arr, int(f), ax)
		if oshape is not None:
			sel = [slice(None)]*arr.ndim
			sel[ax] = slice(0, oshape[ax])
			arr = arr[tuple(sel)]
	return arr


# ---------------------------------------------------------------------------
# Slice boxes [ndim, {start, stop, step}] for extract / insert with the sky
# wrapped in RA (pixell_tpu/utils.py:513-598, :879-912, :1745-1780); host numpy
# ---------------------------------------------------------------------------
def sbox_size(sbox):
	"""The number of pixels each dimension of a slice box covers."""
	sbox = np.asarray(sbox)
	return (np.abs(sbox[:, 1]-sbox[:, 0])+np.abs(sbox[:, 2])-1)//np.abs(sbox[:, 2])


def sbox_wrap(sbox, wrap=0, cap=0):
	"""A slice box that may reach outside an array, split into (inner,
	outer) pairs of slice boxes: reading each inner box of the array
	(wrapped by wrap along a dimension where it is not 0, else cut to
	[0, cap)) and writing to the outer box of the output reproduces the
	wrapped read (pixell_tpu.utils.sbox_wrap)."""
	sbox = np.asarray(sbox, int)
	ndim = len(sbox)
	wrap = np.zeros(ndim, int) + wrap
	cap = np.zeros(ndim, int) + cap
	dim_segments = []
	for d in range(ndim):
		start, stop, step = sbox[d]
		n = (abs(stop-start)+abs(step)-1)//abs(step)
		w = wrap[d]
		c = cap[d] if cap[d] else (w if w else None)
		idx = start + step*np.arange(n)
		if w == 0:
			good = (idx >= 0) & (idx < c) if c is not None else np.ones(n, bool)
		else:
			idx = idx % w
			good = idx < c if c is not None and c < w else np.ones(n, bool)
		dim_segments.append(_runs_to_segs(idx, good, step))
	res = []
	def rec(d, ibox, obox):
		if d == ndim:
			res.append((list(map(tuple, ibox)), list(map(tuple, obox))))
			return
		for iseg, oseg in dim_segments[d]:
			rec(d+1, ibox+[iseg], obox+[oseg])
	rec(0, [], [])
	return res


def _runs_to_segs(idx, good, step):
	"""An explicit index list as maximal contiguous (isel, osel) runs."""
	n, segs, i = len(idx), [], 0
	while i < n:
		if not good[i]:
			i += 1
			continue
		j = i
		while j+1 < n and good[j+1] and idx[j+1]-idx[j] == step: j += 1
		i0, i1 = int(idx[i]), int(idx[j])
		isel = (i0, i1 + (1 if step > 0 else -1), step)
		if step < 0 and isel[1] < 0: isel = (i0, None, step)
		segs.append((isel, (i, j+1, 1)))
		i = j+1
	return segs


def sbox_intersect(a, b, wrap=0):
	"""The intersection of slice boxes a and b [ndim, {start, stop, step}]
	with unit steps, or None where it is empty."""
	a = np.asarray(a); b = np.asarray(b)
	out = np.zeros((a.shape[-2], 3), int)
	for d in range(a.shape[-2]):
		s1, e1 = sorted([a[d, 0], a[d, 1]])
		s2, e2 = sorted([b[d, 0], b[d, 1]])
		s, e = max(s1, s2), min(e1, e2)
		if s >= e: return None
		out[d] = [s, e, 1]
	return out


def sbox_mul(a, b):
	"""The slice box of slicing by a, then by b."""
	a = np.asarray(a); b = np.asarray(b)
	out = np.zeros_like(a)
	out[:, 0] = a[:, 0] + b[:, 0]*a[:, 2]
	out[:, 1] = a[:, 0] + b[:, 1]*a[:, 2]
	out[:, 2] = a[:, 2]*b[:, 2]
	return out


def sbox_div(a, b):
	"""The inverse of sbox_mul: the c with sbox_mul(b, c) == a."""
	a = np.asarray(a); b = np.asarray(b)
	out = np.zeros_like(a)
	out[:, 0] = (a[:, 0] - b[:, 0])//b[:, 2]
	out[:, 1] = (a[:, 1] - b[:, 0])//b[:, 2]
	out[:, 2] = a[:, 2]//b[:, 2]
	return out


def sbox_flip(sbox):
	"""The slice box over the same elements in the other direction."""
	sbox = np.asarray(sbox)
	return np.stack([sbox[..., 1] - np.sign(sbox[..., 2]),
		sbox[..., 0] - np.sign(sbox[..., 2]), -sbox[..., 2]], -1)


def sbox2slice(sbox):
	"""A slice box [:, {start, stop, step}] as (Ellipsis, slices...)."""
	sbox = np.asarray(sbox)
	if sbox.ndim == 1: sbox = sbox[None]
	return (Ellipsis,) + tuple(slice(int(s[0]), int(s[1]) if s[1] >= 0 else None
		if s[1] == -1 and s[2] < 0 else int(s[1]), int(s[2])) for s in sbox)


def sbox_fix0(sbox):
	"""Slice boxes [..., {start, stop}] given unit steps."""
	sbox = np.asarray(sbox)
	if sbox.shape[-1] == 2:
		sbox = np.concatenate([sbox, np.ones(sbox.shape[:-1] + (1,), sbox.dtype)], -1)
	return sbox


def sbox_fix(sbox):
	"""Slice boxes with positive steps, over the same elements."""
	sbox = sbox_fix0(sbox)
	return np.where((sbox[..., 2] < 0)[..., None], sbox_flip(sbox), sbox)


def sbox_intersect_1d(a, b, wrap=0):
	"""The intersections of two 1d slice boxes, with b shifted by -wrap, 0
	and wrap where wrap is given."""
	a = sbox_fix(np.asarray(a)); b = sbox_fix(np.asarray(b))
	res = []
	for s in ([0] if not wrap else [-wrap, 0, wrap]):
		lo, hi = max(a[0], b[0] + s), min(a[1], b[1] + s)
		if hi > lo: res.append([lo, hi, max(a[2], b[2])])
	return res


def czeros(shape, dtype, *, device="cuda"):
	"""Zeros of a (complex) dtype on device (pixell_tpu.utils.czeros :131)."""
	return torch.zeros(shape, dtype=dtype if isinstance(dtype, torch.dtype) else
		torch.from_numpy(np.zeros(0, dtype)).dtype, device=device)


# ---------------------------------------------------------------------------
# Radial Fourier (Hankel) transform (pixell_tpu/utils.py:751), host numpy
# ---------------------------------------------------------------------------
class RadialFourierTransform:
	"""Fast radial Fourier (Hankel) transform between real-space profiles
	f(r) and harmonic profiles F(l), by FFTLog on logarithmically spaced
	points; harm2real and real2harm invert each other on the internal grids
	(pixell_tpu.utils.RadialFourierTransform)."""
	def __init__(self, lrange=None, rrange=None, n=512, pad=256):
		if lrange is None and rrange is None: lrange = [0.1, 1e7]
		if lrange is None: lrange = [1/rrange[1], 1/rrange[0]]
		logl1, logl2 = np.log(lrange[0]), np.log(lrange[1])
		self.n = n
		self.pad = pad
		ntot = n + 2*pad
		self.dlog = (logl2 - logl1)/n
		self.l = np.exp(logl1 + (np.arange(ntot) - pad + 0.5)*self.dlog)
		self.r = 1/self.l[::-1]
		self._mu = 0
	def real2harm(self, rprof):
		"""f(r) -> F(l) = 2 pi int f(r) J0(lr) r dr, f on self.r (a callable
		or an array)."""
		import scipy.fft
		fr = rprof(self.r) if callable(rprof) else np.asarray(rprof)
		A = scipy.fft.fht(fr*self.r, self.dlog, mu=0)
		return 2*np.pi*A/self.l
	def harm2real(self, hprof):
		"""F(l) -> f(r) = 1/(2 pi) int F(l) J0(lr) l dl, the inverse of real2harm."""
		import scipy.fft
		Fl = hprof(self.l) if callable(hprof) else np.asarray(hprof)
		a = scipy.fft.ifht(Fl*self.l/(2*np.pi), self.dlog, mu=0)
		return a/self.r
	def unpad(self, *arrs):
		"""The arrays on the internal grids without their padding."""
		res = tuple(a[..., self.pad:self.pad+self.n] for a in arrs)
		return res[0] if len(res) == 1 else res
	def lind(self, l):
		"""The fractional index of multipole l on the internal log grid."""
		return (np.log(l) - np.log(self.l[0]))/self.dlog
	def rind(self, r):
		"""The fractional index of radius r on the internal log grid."""
		return (np.log(r) - np.log(self.r[0]))/self.dlog


def crossmatch(pos1, pos2, rmax, mode="closest", coords="auto"):
	"""The pairs (i1, i2) of catalogues pos1 [n1, {dec, ra}] and pos2 [n2,
	{dec, ra}] (radians) closer than rmax, by a k-d tree of unit vectors
	(pixell_tpu.utils.crossmatch :853): with mode "closest" each pos1 is
	matched to its closest pos2 only, else to every pos2 in reach."""
	import scipy.spatial
	pos1, pos2 = np.asarray(pos1), np.asarray(pos2)
	if pos1.ndim == 2 and pos1.shape[0] == 2 and pos1.shape[1] != 2: pos1 = pos1.T
	if pos2.ndim == 2 and pos2.shape[0] == 2 and pos2.shape[1] != 2: pos2 = pos2.T
	v1 = ang2rect(np.array([pos1[:, 1], pos1[:, 0]]), axis=0).T
	v2 = ang2rect(np.array([pos2[:, 1], pos2[:, 0]]), axis=0).T
	tree = scipy.spatial.cKDTree(v2)
	chord = 2*np.sin(rmax/2)
	pairs = []
	if mode == "closest":
		d, j = tree.query(v1, k=1)
		for i in range(len(v1)):
			if d[i] <= chord: pairs.append((i, int(j[i])))
	else:
		for i, js in enumerate(tree.query_ball_point(v1, chord)):
			for j in js: pairs.append((i, int(j)))
	return pairs


# ---------------------------------------------------------------------------
# Times, boxes, groups and beams (pixell_tpu/utils.py:967-981, :1234, :1678,
# :1891, :2208), host numpy
# ---------------------------------------------------------------------------
def ctime2mjd(ctime):
	"""Unix time -> modified julian date."""
	return np.asarray(ctime)/86400.0 + 40587.0

def mjd2ctime(mjd):
	return (np.asarray(mjd) - 40587.0)*86400.0

def ctime2djd(ctime):
	"""Unix time -> Dublin julian date (pyephem's epoch)."""
	return np.asarray(ctime)/86400.0 + 40587.0 + 2400000.5 - 2415020

def widen_box(box, margin=1e-3, relative=True):
	"""A box widened by margin (relative to its size by default)."""
	box = np.asarray(box, float)
	m = np.zeros(box.shape[-1] if box.ndim > 1 else ()) + margin
	if relative: m = m*(box[1] - box[0])
	return np.array([box[0] - m/2, box[1] + m/2])

def find_equal_groups(a, tol=0):
	"""The indices of a grouped by equal (within tol) values, groups in
	increasing value."""
	a = np.asarray(a)
	order = np.argsort(a, kind="stable")
	groups = []
	cur = [order[0]] if len(a) else []
	for i in order[1:]:
		if abs(a[i] - a[cur[-1]]) <= tol: cur.append(i)
		else:
			groups.append(cur); cur = [i]
	if cur: groups.append(cur)
	return groups

def find_equal_groups_fast(vals):
	"""(uvals, order, edges): the distinct values of a 1d array, the stable
	order that sorts it, and each group's range in that order."""
	vals = np.asarray(vals)
	order = np.argsort(vals, kind="stable")
	sv = vals[order]
	cut = np.nonzero(np.concatenate([[True], sv[1:] != sv[:-1]]))[0]
	edges = np.concatenate([cut, [len(sv)]])
	return sv[cut], order, edges

def calc_beam_area(beam_profile):
	"""The beam area in steradians from profile[{r, b}, :]."""
	r, b = np.asarray(beam_profile)
	return np.trapezoid(2*np.pi*np.sin(r)*b, r) if hasattr(np, "trapezoid") else np.trapz(2*np.pi*np.sin(r)*b, r)


# ---------------------------------------------------------------------------
# Host-data communication (pixell_tpu/utils.py:731-744, :2857-2866): numpy in
# and out over a communicator (parallel.dist), the identity without one
# ---------------------------------------------------------------------------
def allreduce(a, comm=None, op=None):
	"""allreduce of a over comm; a itself with no communicator or one rank
	(pixell_tpu.utils.allreduce :731)."""
	if comm is None or getattr(comm, "size", 1) == 1: return a
	return comm.allreduce(a, op=op)

def allgather(a, comm=None):
	"""[size, ...]: a from every rank (pixell_tpu.utils.allgather :736)."""
	if comm is None or getattr(comm, "size", 1) == 1:
		return np.asarray(a)[None]
	return comm.allgather(a)

def allgatherv(a, comm=None, axis=0):
	"""Every rank's a, of any length along axis, concatenated in rank order
	(pixell_tpu.utils.allgatherv :741)."""
	if comm is None or getattr(comm, "size", 1) == 1:
		return np.asarray(a)
	return comm.allgatherv(a, axis=axis)

def send(a, comm, dest=0, tag=0):
	"""Send a numpy array: its shape and dtype, then its data
	(pixell_tpu.utils.send :2857)."""
	a = np.ascontiguousarray(a)
	comm.send((a.shape, a.dtype.str), dest=dest, tag=tag)
	comm.Send(a, dest=dest, tag=tag)

def recv(comm, source=0, tag=0):
	"""The array send sent (pixell_tpu.utils.recv :2863)."""
	shape, dtype = comm.recv(source=source, tag=tag)
	res = np.empty(shape, dtype)
	comm.Recv(res, source=source, tag=tag)
	return res


# ---------------------------------------------------------------------------
# The device and small helpers (pixell_tpu/utils.py:96-190). A tensor stays on
# its device; where the reference picks jnp or numpy (_xp), a tensor goes
# through torch and anything else through numpy.
# ---------------------------------------------------------------------------
def _xp(*args):
	"""torch if any argument is a tensor, else numpy (pixell_tpu.utils._xp)."""
	return torch if any(isinstance(x, torch.Tensor) for x in args) else np


def _torch_dtype(dtype):
	if dtype is None or isinstance(dtype, torch.dtype): return dtype
	return torch.from_numpy(np.zeros(0, dtype)).dtype


def to_device(x, dtype=None, *, device="cuda"):
	"""x as a tensor on device, in dtype (numpy or torch) if given
	(pixell_tpu.utils.to_device :96, without its separate transfer of a
	complex array's real and imaginary parts, which a remote TPU runtime
	needed)."""
	if isinstance(x, torch.Tensor): out = x.to(device)
	else: out = torch.as_tensor(np.asarray(x), device=device)
	return out if dtype is None else out.to(_torch_dtype(dtype))


def from_device(x):
	"""x as a numpy array on the host (pixell_tpu.utils.from_device :145)."""
	if isinstance(x, torch.Tensor): return x.detach().resolve_conj().cpu().numpy()
	return np.asarray(x)


def ceil(a):  return int(np.ceil(a))
def floor(a): return int(np.floor(a))


def first_importable(*args):
	"""The first of the module names given that imports, or None."""
	for name in args:
		try:
			__import__(name)
			return name
		except ImportError:
			continue
	return None


def cumsum(a, endpoint=False):
	"""The exclusive cumulative sum [0, a0, a0+a1, ...], with the total at
	the end if endpoint."""
	res = np.concatenate([[0], np.cumsum(a)])
	return res if endpoint else res[:-1]


def between_angles(a, range, period=2*np.pi):
	"""Whether the angles a lie in [range[0], range[1]), modulo period."""
	a = rewind(a, ref=np.mean(range), period=period)
	return (a >= range[0]) & (a < range[1])


# ---------------------------------------------------------------------------
# Binning (pixell_tpu/utils.py:314-355), host numpy
# ---------------------------------------------------------------------------
def linbin(n, nbin=None, nmin=None, bsize=None):
	"""Linear bin edges [nbin, {from, to}] for data of length n."""
	if bsize is None:
		if nbin is None: nbin = int(np.round(n**0.5))
		bsize = n/nbin
	if nmin is not None: bsize = max(bsize, nmin)
	nbin  = int(np.ceil(n/bsize))
	edges = np.arange(nbin+1)*bsize
	return np.stack([edges[:-1], edges[1:]], -1).astype(int)


def expbin(n, nbin=None, nmin=8, nmax=0):
	"""Exponentially growing bin edges [nbin, {from, to}], bins narrower
	than nmin merged into the next, those wider than nmax (if given)
	dropped."""
	if nbin is None: nbin = int(np.round(n**0.5))
	edges = np.exp(np.linspace(0, np.log(n), nbin+1))
	edges = np.unique(np.maximum(nint(edges)-1, 0))
	res = np.stack([edges[:-1], edges[1:]], -1)
	if nmin:
		keep = []
		last = 0
		for i in range(len(res)):
			if res[i, 1]-last >= nmin or i == len(res)-1:
				keep.append((last, res[i, 1])); last = res[i, 1]
		res = np.array(keep)
	if nmax:
		res = res[res[:, 1]-res[:, 0] <= nmax]
	return res


def bin_data(bins, d, op=np.mean):
	"""op of the last axis of d over each of bins [nbin, {from, to}]."""
	d  = np.asarray(d)
	res = np.empty(d.shape[:-1] + (len(bins),), d.dtype)
	for bi, b in enumerate(bins):
		res[..., bi] = op(d[..., b[0]:b[1]], -1)
	return res


def interpol(a, inds, order=3, mode="nearest", cval=0.0, prefilter=True):
	"""a interpolated at the fractional indices inds [ndim, ...] by
	interpol.map_coordinates with border=mode (pixell_tpu.utils.interpol
	:343), which keeps a tensor on its device and takes host data to the CPU."""
	from . import interpol as _ip
	return _ip.map_coordinates(a, inds, order=order, border=mode, cval=cval, prefilter=prefilter)


# ---------------------------------------------------------------------------
# Beams, spectra and solving (pixell_tpu/utils.py:360-476)
# ---------------------------------------------------------------------------
def gauss_beam(l, fwhm_rad):
	"""The harmonic Gaussian beam b(l) of the given FWHM in radians."""
	xp = _xp(l)
	sigma = fwhm_rad*fwhm
	return xp.exp(-0.5*l*(l+1)*sigma**2)


def compress_beam(sigma, phi):
	"""An elliptical beam's (sigma_x, sigma_y) and angle phi as its three
	independent inverse-covariance entries."""
	c = np.cos(2*phi); s = np.sin(2*phi)
	sx, sy = sigma
	return np.array([sx**2*c**2+sy**2*s**2, sx**2*s**2+sy**2*c**2, (sx**2-sy**2)*c*s])


def expand_beam(irads, return_V=False):
	"""The inverse of compress_beam: (sigma, phi), and the eigenvectors V
	with return_V."""
	C = np.array([[irads[0], irads[2]], [irads[2], irads[1]]])
	E, V = np.linalg.eigh(C)
	phi = np.arctan2(V[1, 1], V[0, 1])
	sigma = E[::-1]**0.5
	if return_V: return sigma, phi, V
	return sigma, phi


def regularize_beam(bl, cutoff=0.01, nl=None, normalize=False):
	"""The beam b(l) with its tail below cutoff continued at the constant
	logarithmic slope of the two degrees before it, so that dividing by it
	is safe; nl degrees (the last value repeated past the input)."""
	bl = np.asarray(bl, float)
	if normalize: bl = bl/bl[0]
	if nl is None: nl = len(bl)
	res = np.empty(nl)
	n   = min(len(bl), nl)
	res[:n] = bl[:n]
	if nl > len(bl): res[len(bl):] = bl[-1]
	below = np.where(res < cutoff)[0]
	if len(below) > 0:
		i0 = below[0]
		if i0 > 1:
			slope = np.log(res[i0-1]/res[i0-2])
			l = np.arange(nl-i0)+1
			res[i0:] = res[i0-1]*np.exp(slope*l)
		else:
			res[:] = np.maximum(res, cutoff)
	return res


def solve(A, b, axes=[0, 1], masked=False):
	"""x with A x = b, A possibly singular (its pseudo-inverse by eigpow):
	tensors on their device, numpy on the host."""
	xp = _xp(A, b)
	iA = eigpow(A, -1, axes=axes)
	ax1, ax2 = axes
	return xp.einsum("...ij,...j->...i",
		xp.moveaxis(iA, (ax1 % iA.ndim, ax2 % iA.ndim), (-2, -1)),
		xp.moveaxis(b, ax1 % b.ndim, -1))


def planck(f, T=T_cmb):
	"""The Planck spectral radiance B(f, T) [W/sr/m^2/Hz]."""
	xp = _xp(f, T)
	return 2*h*f**3/c**2/(xp.exp(h*f/(k*T))-1)


def dplanck(f, T=T_cmb):
	"""dB/dT of the Planck spectrum."""
	xp = _xp(f, T)
	x = h*f/(k*T)
	return 2*h**2*f**4/(c**2*k*T**2)*xp.exp(x)/(xp.exp(x)-1)**2


def graybody(f, T=10.0, beta=1.0):
	return f**beta*planck(f, T)


def blackbody(f, T=T_cmb):
	return planck(f, T)


def tsz_spectrum(f, T=T_cmb):
	"""The thermal SZ frequency dependence in spectral radiance units."""
	xp = _xp(f)
	x  = h*f/(k*T)
	return dplanck(f, T)*T*(x*(xp.exp(x)+1)/(xp.exp(x)-1) - 4)


def flux_factor(beam_area, freq, T0=T_cmb):
	"""The conversion from uK to mJy for a beam solid angle and frequency."""
	return dplanck(freq, T0)*1e-6*beam_area*1e26*1e3


def fix_dtype(dtype):
	"""dtype as a numpy dtype; a torch dtype is returned as it is."""
	return dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)


# ---------------------------------------------------------------------------
# Printing (pixell_tpu/utils.py:716-739)
# ---------------------------------------------------------------------------
class Printer:
	"""Writes to stderr what is at or below its level (exactly at it with
	exact), behind its prefix; push adds to the prefix, time() times a
	block and writes the seconds with the description."""
	def __init__(self, level=1, prefix=""):
		self.level = level; self.prefix = prefix
	def write(self, desc, level=1, exact=False, newline=True):
		if level == self.level or (not exact and level <= self.level):
			import sys
			sys.stderr.write("%s%s%s" % (self.prefix, desc, "\n" if newline else ""))
	def push(self, desc):
		return Printer(self.level, self.prefix + desc)
	def time(self, desc, level=1, exact=False):
		return _PrintTimer(self, desc, level, exact)


class _PrintTimer:
	def __init__(self, printer, desc, level, exact):
		self.printer, self.desc, self.level, self.exact = printer, desc, level, exact
	def __enter__(self):
		import time
		self.t1 = time.time()
		return self
	def __exit__(self, *args):
		import time
		self.printer.write("%6.2f %s" % (time.time()-self.t1, self.desc), self.level, self.exact)


# ---------------------------------------------------------------------------
# Log-spaced transforms (pixell_tpu/utils.py:807-862), scipy's FFTLog on the host
# ---------------------------------------------------------------------------
def profile_to_tform_hankel(profile_fun, lmin=0.1, lmax=1e7, n=512, pad=256):
	"""(l, F(l)): the harmonic profile of a radial profile function."""
	rft = RadialFourierTransform(lrange=[lmin, lmax], n=n, pad=pad)
	F = rft.real2harm(profile_fun)
	l, F = rft.unpad(rft.l, F)
	return l, F


class FFTLog:
	"""The Fourier transform of log-spaced data, from a pair of fast Hankel
	transforms at mu = -1/2 and +1/2. The domain is xrange = [xmin, xmax]
	or krange = [kmin, kmax] (one of them); pad widens it by pad points on
	each side (unpad strips them); bias sets the power-law boundary
	conditions."""
	def __init__(self, xrange=None, krange=None, n=512, pad=0, bias=0):
		if (xrange is None) == (krange is None):
			raise ValueError("Either xrange xor krange must be given")
		if xrange is None: xrange = krange[::-1]
		self.step = (np.log(xrange[1]) - np.log(xrange[0]))/(n - 1)
		self.pad  = pad
		self.n    = n
		self.x  = np.exp(np.linspace(np.log(xrange[0]) - self.step*pad,
			np.log(xrange[1]) + self.step*pad, n + 2*pad))
		self.k  = 1/self.x[::-1]
		self.xh = self.x**(0.5 - bias)
		self.kh = self.k**(0.5 + bias)
		# the normalization folded into kh; the inverse keeps a factor 2
		self.kh /= (np.pi/2)**0.5
		self.bias = bias
	def fft(self, a):
		"""The transform along the last axis of a, sampled at self.x (a
		callable is evaluated there)."""
		import scipy.fft
		try: a = a(self.x)
		except TypeError: pass
		xa  = a*self.xh
		cos = scipy.fft.fht(xa, self.step, -0.5, bias=self.bias)/self.kh
		sin = scipy.fft.fht(xa, self.step, +0.5, bias=self.bias)/self.kh
		return cos - 1j*sin
	def ifft(self, fa):
		"""The inverse along the last axis of fa, sampled at self.k."""
		import scipy.fft
		try: fa = fa(self.k)
		except TypeError: pass
		kfa = fa*(self.kh/2)
		a  = scipy.fft.ifht(kfa.real, self.step, -0.5, bias=self.bias)/self.xh
		a += scipy.fft.ifht(-kfa.imag, self.step, +0.5, bias=self.bias)/self.xh
		return a
	def unpad(self, *arrs):
		"""The arrays on this object's grids without their padding."""
		if self.pad == 0: res = arrs
		else: res = tuple(arr[..., self.pad:arr.shape[-1]-self.pad] for arr in arrs)
		return res[0] if len(arrs) == 1 else res


# ---------------------------------------------------------------------------
# Interpolators (pixell_tpu/utils.py:941-985): the data stay on their device
# (host data go to device), and so does the result
# ---------------------------------------------------------------------------
def _pix_of(coords, box, n, dev):
	"""Pixel positions [ndim, ...] of coords inside box [{from, to}, ndim]
	over n pixels (n - 1 intervals for the spline, n for the Fourier
	grid), in float64 on dev; without a box, coords themselves."""
	coords = coords.to(dev, torch.float64) if isinstance(coords, torch.Tensor) else \
		torch.as_tensor(np.asarray(coords, np.float64), device=dev)
	if box is None: return coords
	shp = (-1,) + (1,)*(coords.ndim - 1)
	lo = torch.as_tensor(box[0], device=dev).reshape(shp)
	width = torch.as_tensor(box[1] - box[0], device=dev).reshape(shp)
	return (coords - lo)/width*torch.as_tensor(n, dtype=torch.float64, device=dev).reshape(shp)


class SplineInterpolator:
	"""A spline interpolator of gridded data: data [..., n1, ..., nd] at
	coords [d, ...], in the box's units if a box [{from, to}, d] is given,
	else in pixels (pixell_tpu.utils.SplineInterpolator :941)."""
	def __init__(self, data, box=None, order=3, border="cyclic", *, device="cuda"):
		self.data = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data), device=device)
		self.box = np.asarray(box) if box is not None else None
		self.order = order
		self.border = border
	def __call__(self, coords):
		from . import interpol as _ip
		nd = len(coords)
		n = np.array(self.data.shape[self.data.ndim-nd:]) - 1
		pix = _pix_of(coords, self.box, n, self.data.device)
		return _ip.map_coordinates(self.data, pix, order=self.order, border=self.border)


class FourierInterpolator:
	"""A band-limited interpolator of periodic gridded data [..., ny, nx],
	at coords [{y, x}, ...] in the box's units (box [{from, to}, 2] spans
	the whole period) or in pixels, by fft.interpol_nufft: K12 and K10 on
	the card (pixell_tpu.utils.FourierInterpolator :962)."""
	def __init__(self, data, box=None, *, device="cuda"):
		self.data = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data), device=device)
		self.box = np.asarray(box) if box is not None else None
	def __call__(self, coords):
		from . import fft as _fft
		nd = len(coords)
		n = np.array(self.data.shape[self.data.ndim-nd:])
		pix = _pix_of(coords, self.box, n, self.data.device)
		return _fft.interpol_nufft(self.data, pix)


def interpolator(data, box=None, mode="spline", order=3, border="cyclic", *, device="cuda"):
	"""SplineInterpolator (mode spline, conv, lin / linear of order 1,
	cubic of order 3) or FourierInterpolator (fourier, fft, nufft)."""
	if mode in ["spline", "conv", "lin", "linear", "cubic"]:
		o = {"lin": 1, "linear": 1, "cubic": 3}.get(mode, order)
		return SplineInterpolator(data, box=box, order=o, border=border, device=device)
	if mode in ["fourier", "fft", "nufft"]:
		return FourierInterpolator(data, box=box, device=device)
	raise ValueError(mode)


# ---------------------------------------------------------------------------
# Files, integers, robust means (pixell_tpu/utils.py:987-1012)
# ---------------------------------------------------------------------------
def dump(fname, obj):
	"""obj pickled into fname."""
	import pickle
	with open(fname, "wb") as f: pickle.dump(obj, f)


def loadtxt(fname): return np.loadtxt(fname)


def nint_div(a, b): return (a + b//2)//b


def medmean(a, frac=0.5):
	"""The mean of the central frac of the sorted values, a robust mean: a
	tensor's on its device (a 0-d tensor), else numpy's."""
	if isinstance(a, torch.Tensor):
		a = torch.sort(a.reshape(-1))[0]
	else:
		a = np.sort(np.asarray(a).reshape(-1))
	n = len(a)
	lo = int(n*(1-frac)/2); hi = n - lo
	return a[lo:hi].mean()


# ---------------------------------------------------------------------------
# The tSZ cluster profile (pixell_tpu/utils.py:1015-1030): the generalized NFW
# pressure profile of Battaglia et al. 2012 and its line-of-sight projection
# ---------------------------------------------------------------------------
def tsz_profile_raw(x, xc=0.497, alpha=1.0, beta=4.65, gamma=-0.3):
	"""The dimensionless gNFW pressure profile P(x), x = r/R200c: a tensor
	on its device, else numpy."""
	if not isinstance(x, torch.Tensor): x = np.asarray(x)
	return (x/xc)**gamma*(1 + (x/xc)**alpha)**(-beta)


def tsz_profile_los(x, xc=0.497, alpha=1.0, beta=4.65, gamma=-0.3,
		zmax=1e5, npoint=200, x1=1e-8, x2=1e4):
	"""The gNFW profile projected on the line of sight at projected radii x:
	2 int P(sqrt(x^2 + z^2)) dz, by a log-spaced quadrature in z (host numpy)."""
	x = np.atleast_1d(np.asarray(x, float))
	t = np.linspace(-8, np.log10(zmax), npoint)
	z = 10.0**t
	dz = z*np.log(10)*(t[1]-t[0])
	r = np.sqrt(x[:, None]**2 + z[None, :]**2)
	P = tsz_profile_raw(r, xc=xc, alpha=alpha, beta=beta, gamma=gamma)
	return 2*np.sum(P*dz[None, :], -1)


def tsz_profile_los_fast(x, **kwargs):
	"""tsz_profile_los interpolated in log-log from 400 radii in [1e-6, 1e3]."""
	xs = np.exp(np.linspace(np.log(1e-6), np.log(1e3), 400))
	ys = tsz_profile_los(xs, **kwargs)
	return np.exp(np.interp(np.log(np.maximum(np.asarray(x), 1e-6)),
		np.log(xs), np.log(np.maximum(ys, 1e-300))))


class DataError(Exception): pass
class DataMissing(DataError): pass
