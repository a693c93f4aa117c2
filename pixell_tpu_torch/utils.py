"""Constants and helpers (counterpart of pixell_tpu/utils.py): every public
name of the reference but cached_jit and fence, with its parameters.

The constants are the reference's, and most helpers are host code on numpy,
as there: strings, files and the environment, dates and time scales,
ranges, bins, boxes and slice boxes (sbox_*), iterators, scalar formulas
and physics, parsing and formatting, the FFTLog and Hankel transforms
(scipy), crossmatch (scipy's k-d tree), the solvers' vectors (Minres; CG
also on tensors) and the communicator helpers (allreduce, allgather(v),
send / recv, reduce, redistribute) over any communicator with mpi4py's
calls, parallel.dist.TorchCommunicator on torch.distributed among them.

The helpers that do array work on data a user holds as a map also take a
torch.Tensor and then compute with torch on its device, returning tensors
there (numpy input still gives the reference's numpy result): the angle
and geometry helpers rewind, rotmatrix, interp, vec_angdist, ang2chord /
chord2ang, point_in_polygon, poly_edge_dist; the statistics medmean,
medmean2, maskmed, weighted_quantile / weighted_median (numpy's order
statistics and interpolation), minmax, rescale, argmax / argmin,
find_first / find_last; the counting bincount, bin_multi, sum_by_id; the
reshaping block_reduce / block_expand, downgrade / upgrade,
partial_flatten / partial_expand, flatview, moveaxes, addaxes, delaxes,
atleast_3d / atleast_Nd, to_Nd, preflat / postflat, blockify,
block_mean_filter, slice_downgrade, resize_array, unmask; the elementwise
tofinite, remove_nan, without_nan, triangle_wave, gnfw, pixwin_1d,
gauss_beam, planck and its kin; the linear algebra eigpow, solve, matvec,
cov2corr / corr2cov, eigsort, nodiag, deslope. to_device, from_device and
czeros move data to and from a device ("cuda" by default), and the
interpolators keep their data there (FourierInterpolator on the NUFFT's
kernels).

Not ported: cached_jit and fence, and to_device's separate transfer of a
complex array's parts, which worked around a remote TPU runtime. Where the
reference's helper is at fault the port is not, and says so beside the
code (ROADMAP.md, Queue 3): reduce, redistribute, deslope, rewind_compact,
poly_edge_dist, disk_overlap_curved and tsz_profile_los_exact.
"""
from __future__ import annotations
import itertools
import os
import re
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


EIGH_CHUNK = 16384   # matrices a torch.linalg.eigh call takes on the card (cuSOLVER's batched syev refused
                     # 291,600 3 x 3 ones with CUSOLVER_STATUS_INVALID_VALUE: H100, torch 2.11, CUDA 12.8)


def _eigh(A):
	"""torch.linalg.eigh of a stack of symmetric matrices [..., n, n]; on a
	CUDA tensor EIGH_CHUNK matrices a call."""
	flat = A.reshape((-1,) + tuple(A.shape[-2:]))
	if not A.is_cuda or flat.shape[0] <= EIGH_CHUNK: return torch.linalg.eigh(A)
	parts = [torch.linalg.eigh(flat[i:i+EIGH_CHUNK]) for i in range(0, flat.shape[0], EIGH_CHUNK)]
	return torch.cat([p[0] for p in parts]).reshape(A.shape[:-1]), torch.cat([p[1] for p in parts]).reshape(A.shape)


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
	E, V = _eigh(A) if xp is torch else np.linalg.eigh(A)
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


# ---------------------------------------------------------------------------
# Lists and search (pixell_tpu/utils.py:1036-1227). Host numpy, but for
# find_first / find_last, unmask and argmax / argmin, which also take a
# tensor and answer on its device.
# ---------------------------------------------------------------------------
def l2ang(l):
	"""The angular scale, in radians, that multipole l corresponds to."""
	return (4*np.pi)**0.5/(l + 1)


def ang2l(ang):
	"""The multipole that the angular scale ang (radians) corresponds to."""
	return (4*np.pi)**0.5/ang - 1


def D(f, eps=1e-10):
	"""The complex-step derivative of f: D(f)(x) = Im f(x + i eps)/eps."""
	def Df(x): return f(x + eps*1j).imag/eps
	return Df


def lines(file_or_fname):
	"""The lines of a file, given by name or open."""
	if isinstance(file_or_fname, str):
		with open(file_or_fname, "r") as f:
			for line in f: yield line
	else:
		for line in file_or_fname: yield line


def touch(fname):
	"""Create fname if missing, and set its modification time to now."""
	with open(fname, "a"):
		os.utime(fname)


def listsplit(seq, elem):
	"""seq split into lists at each occurrence of elem, as str.split."""
	cuts = [i for i, v in enumerate(seq) if v == elem]
	bounds = [-1] + cuts + [len(seq)]
	return [list(seq[bounds[i]+1:bounds[i+1]]) for i in range(len(bounds)-1)]


def streq(x, s):
	"""Whether x is the string s (False for anything that is not a string)."""
	return isinstance(x, str) and x == s


def find_any(array, vals, sorted=False):
	"""The indices in array of those of vals that it holds."""
	array = np.asarray(array); vals = np.atleast_1d(vals)
	order = np.argsort(array) if not sorted else None
	a = array[order] if order is not None else array
	i = np.searchsorted(a, vals)
	i = np.clip(i, 0, len(a)-1)
	hit = a[i] == vals
	res = i[hit]
	return order[res] if order is not None else res


def find_first(mask, axis=-1, default=-1):
	"""The index of the first true entry of mask along axis, or default
	where there is none: a tensor's on its device, else numpy's."""
	if isinstance(mask, torch.Tensor):
		mask = mask.to(torch.bool)
		return torch.where(mask.any(axis), torch.argmax(mask.to(torch.uint8), axis), default)
	mask = np.asarray(mask, bool)
	any_ = mask.any(axis)
	ind = np.argmax(mask, axis)
	return np.where(any_, ind, default)


def find_last(mask, axis=-1, default=-1):
	"""The index of the last true entry of mask along axis, or default."""
	if isinstance(mask, torch.Tensor):
		mask = mask.to(torch.bool)
		ind = mask.shape[axis] - 1 - torch.argmax(torch.flip(mask, [axis]).to(torch.uint8), axis)
		return torch.where(mask.any(axis), ind, default)
	mask = np.asarray(mask, bool)
	n = mask.shape[axis]
	rev = np.flip(mask, axis)
	any_ = mask.any(axis)
	ind = n - 1 - np.argmax(rev, axis)
	return np.where(any_, ind, default)


def find_range(ranges, vals, sorted=False, default=-1):
	"""Which of ranges [nrange, {from, to}] each of vals falls in, or default."""
	ranges = np.asarray(ranges); vals = np.asarray(vals)
	order = np.argsort(ranges[:, 0]) if not sorted else np.arange(len(ranges))
	r = ranges[order]
	i = np.searchsorted(r[:, 0], vals, side="right") - 1
	ok = (i >= 0) & (vals < r[np.clip(i, 0, len(r)-1), 1])
	return np.where(ok, order[np.clip(i, 0, len(r)-1)], default)


def nearest_ind(arr, vals, sorted=False):
	"""The index in arr of the value closest to each of vals."""
	arr = np.asarray(arr); vals = np.asarray(vals)
	order = None if sorted else np.argsort(arr)
	a = arr[order] if order is not None else arr
	i = np.searchsorted(a, vals)
	i = np.clip(i, 1, len(a)-1)
	left = a[i-1]; right = a[i]
	i = i - (np.abs(vals - left) <= np.abs(vals - right))
	return order[i] if order is not None else i


def contains(array, vals):
	"""Which elements of array are among vals."""
	return np.isin(np.asarray(array), np.asarray(vals))


def asfarray(arr, default_dtype=np.float64):
	"""arr as an array, of default_dtype unless it is float or complex."""
	arr = np.asarray(arr)
	if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.complexfloating):
		return arr
	return arr.astype(default_dtype)


def common_vals(arrs):
	"""The values every one of arrs holds, sorted."""
	res = np.asarray(arrs[0])
	for a in arrs[1:]: res = np.intersect1d(res, a)
	return res


def common_inds(arrs):
	"""For each of arrs, the indices of the values they all hold."""
	vals = common_vals(arrs)
	return [find_any(a, vals, sorted=False) for a in arrs]


def union(arrs):
	"""The values any of arrs holds, sorted."""
	res = np.asarray(arrs[0])
	for a in arrs[1:]: res = np.union1d(res, a)
	return res


def inverse_order(order):
	"""The inverse permutation of order."""
	order = np.asarray(order)
	inv = np.empty_like(order)
	inv[order] = np.arange(len(order))
	return inv


def complement_inds(inds, n):
	"""The values of range(n) that inds lacks."""
	mask = np.ones(n, bool)
	if inds is not None and len(np.atleast_1d(inds)) > 0:
		mask[np.asarray(inds)] = False
	return np.nonzero(mask)[0]


def unmask(arr, mask, axis=0, fill=0):
	"""The inverse of arr = res[mask] along axis, fill where mask is false: a
	tensor's on its device, else numpy's."""
	if isinstance(arr, torch.Tensor):
		mask = torch.as_tensor(mask, device=arr.device).to(torch.bool)
		axis = axis % arr.ndim
		res = torch.full(arr.shape[:axis] + mask.shape + arr.shape[axis+1:], fill, dtype=arr.dtype,
			device=arr.device)
		res[(slice(None),)*axis + (mask,)] = arr
		return res
	arr = np.asarray(arr); mask = np.asarray(mask, bool)
	axis = axis % arr.ndim
	shape = arr.shape[:axis] + mask.shape + arr.shape[axis+1:]
	res = np.full(shape, fill, arr.dtype)
	sel = (slice(None),)*axis + (mask,)
	res[sel] = arr
	return res


def dict_apply_listfun(dict_, function):
	"""function applied to the list of dict_'s values, as a dict by the same keys."""
	keys = list(dict_.keys())
	vals = function([dict_[k] for k in keys])
	return {k: v for k, v in zip(keys, vals)}


def dict_lookup(dict_, vals):
	"""dict_[v] for each of the array vals, as an array."""
	keys = list(dict_.keys())
	res = None
	vals = np.asarray(vals)
	for k in keys:
		v = np.asarray(dict_[k])
		if res is None:
			res = np.zeros(vals.shape + v.shape, v.dtype)
		res[vals == k] = v
	return res


def fallback(*args):
	"""The first of args that is not None."""
	for a in args:
		if a is not None: return a
	return None


def cumsplit(sizes, capacities):
	"""How many of sizes, in order, fit into the cumulative capacities."""
	return np.searchsorted(np.cumsum(sizes), np.cumsum(capacities), side="right")


def mask2range(mask):
	"""The runs of true values of a 1d mask as ranges [:, {start, stop}]."""
	mask = np.concatenate([[False], np.asarray(mask, bool), [False]]).astype(int)
	d = np.diff(mask)
	starts = np.nonzero(d == 1)[0]
	stops = np.nonzero(d == -1)[0]
	return np.stack([starts, stops], -1)


def repeat_filler(d, n):
	"""n values made by repeating d forwards, then backwards, and so on."""
	d = np.asarray(d)
	tile = np.concatenate([d, d[::-1]])
	reps = (n + len(tile) - 1)//len(tile)
	return np.tile(tile, reps)[:n]


def repeat(arr, n, axis=-1):
	"""arr tiled n times along axis."""
	arr = np.asarray(arr)
	reps = [1]*arr.ndim
	reps[axis] = n
	return np.tile(arr, reps)


def _unravel(flat, shape):
	"""np.unravel_index of the 0-d integer tensor flat, by // and % on its
	device (torch.unravel_index's first call took 4.1 s on an H100 with
	torch 2.11, in its Python checks)."""
	out = []
	for n in reversed(shape):
		out.append(flat % n)
		flat = flat//n
	return tuple(reversed(out))


def argmax(arr):
	"""The index tuple of arr's largest value (the first of equal ones): a
	tensor's as 0-d tensors on its device."""
	if isinstance(arr, torch.Tensor): return _unravel(torch.argmax(arr), arr.shape)
	arr = np.asarray(arr)
	return np.unravel_index(np.argmax(arr), arr.shape)


def argmin(arr):
	"""The index tuple of arr's smallest value."""
	if isinstance(arr, torch.Tensor): return _unravel(torch.argmin(arr), arr.shape)
	arr = np.asarray(arr)
	return np.unravel_index(np.argmin(arr), arr.shape)


# ---------------------------------------------------------------------------
# Time scales (pixell_tpu/utils.py:1230-1251): modified, Dublin and plain
# julian dates, unix time, years, dates
# ---------------------------------------------------------------------------
def mjd2djd(mjd):   return np.asarray(mjd) + 2400000.5 - 2415020
def djd2mjd(djd):   return np.asarray(djd) - 2400000.5 + 2415020
def mjd2jd(mjd):    return np.asarray(mjd) + 2400000.5
def jd2mjd(jd):     return np.asarray(jd) - 2400000.5
def djd2ctime(djd): return (np.asarray(djd) - (40587.0 + 2400000.5 - 2415020))*86400.0
def ctime2jd(ctime): return np.asarray(ctime)/86400.0 + 40587.0 + 2400000.5
def jd2ctime(jd):   return (np.asarray(jd) - (40587.0 + 2400000.5))*86400.0
def yr2ctime(yr):   return (np.asarray(yr) - 1970.0)*86400*365.2425
def ctime2yr(ctime): return np.asarray(ctime)/(86400*365.2425) + 1970.0


def ctime2date(timestamp, tzone=0, fmt="%Y-%m-%d"):
	"""The date of a unix time, tzone hours east of UTC, formatted by fmt."""
	import time as _time
	return _time.strftime(fmt, _time.gmtime(np.asarray(timestamp) + tzone*3600))


def date2ctime(dstr):
	"""The unix time of a date "YYYY-MM-DD", with " HH:MM:SS" or "THH:MM:SS"."""
	import datetime, calendar
	for f in ["%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"]:
		try:
			return calendar.timegm(datetime.datetime.strptime(dstr.strip(), f).timetuple())
		except ValueError: continue
	raise ValueError("Unrecognized date format: %s" % dstr)


# ---------------------------------------------------------------------------
# Statistics and shaping (pixell_tpu/utils.py:1255-1415). The statistics and
# the reshaping helpers take tensors too, and compute on their device.
# ---------------------------------------------------------------------------
def _float64(x):
	"""A tensor in float64 unless it is already floating or complex."""
	return x if x.is_floating_point() or x.is_complex() else x.to(torch.float64)


def _array(a):
	"""A tensor as it is, anything else as a numpy array."""
	return a if isinstance(a, torch.Tensor) else np.asarray(a)


def medmean2(x, axis=None, frac=0.1, bsize=None):
	"""The mean of the central values of x (a fraction frac cut off at either
	end of its sorted values), over axis or over everything; bsize is
	accepted and ignored, as in the reference."""
	if isinstance(x, torch.Tensor):
		x = _float64(x)
		if axis is None:
			v = torch.sort(x.reshape(-1))[0]
			n = v.shape[0]; i1 = int(n*frac); i2 = max(i1+1, n - i1)
			return v[i1:i2].mean()
		v = torch.sort(x, dim=axis)[0]
	else:
		x = np.asarray(x)
		if axis is None:
			v = np.sort(x.reshape(-1))
			n = len(v); i1 = int(n*frac); i2 = max(i1+1, n - i1)
			return np.mean(v[i1:i2])
		v = np.sort(x, axis=axis)
	n = x.shape[axis]; i1 = int(n*frac); i2 = max(i1+1, n - i1)
	sel = [slice(None)]*x.ndim; sel[axis] = slice(i1, i2)
	return v[tuple(sel)].mean(axis)


def _nanmedian(a, axis):
	"""numpy's nanmedian of a float tensor along axis: the middle of the
	values that are not NaN, the mean of the two middle ones for an even
	count, NaN where every value is."""
	s = torch.sort(torch.movedim(a, axis, -1), -1)[0]    # NaN sorts last
	n = (~torch.isnan(s)).sum(-1, keepdim=True)
	lo = torch.gather(s, -1, ((n - 1)//2).clamp(min=0))
	hi = torch.gather(s, -1, (n//2).clamp(max=s.shape[-1] - 1))
	return torch.where(n % 2 == 1, lo, (lo + hi)/2)[..., 0]


def maskmed(arr, mask=None, axis=-1, maskval=0):
	"""The median along axis of the entries not masked (mask false, or equal
	to maskval without a mask), maskval where none is left; NaN entries are
	left out too. float64, on a tensor's device."""
	if isinstance(arr, torch.Tensor):
		bad = (arr == maskval) if mask is None else ~torch.as_tensor(mask, device=arr.device).to(torch.bool)
		work = arr.to(torch.float64).masked_fill(bad, torch.nan)
		return torch.nan_to_num(_nanmedian(work, axis), nan=maskval)
	arr = np.asarray(arr)
	bad = (arr == maskval) if mask is None else ~np.asarray(mask, bool)
	work = np.where(bad, np.nan, arr.astype(float))
	res = np.nanmedian(work, axis=axis)
	return np.nan_to_num(res, nan=maskval)


def moveaxes(a, old, new):
	"""a with the axes old moved to the positions new."""
	if isinstance(a, torch.Tensor):
		return torch.movedim(a, tuple(int(o) for o in np.atleast_1d(old)), tuple(int(n) for n in np.atleast_1d(new)))
	return np.moveaxis(a, np.atleast_1d(old), np.atleast_1d(new))


def search(a, v, side="left"):
	"""searchsorted row by row: the position of v[...] in a[..., n]."""
	a = np.asarray(a); v = np.asarray(v)
	cmp = (a < v[..., None]) if side == "left" else (a <= v[..., None])
	return np.sum(cmp, -1)


def _interp_rows(x, xp, fp):
	"""np.interp(x, xp[i], fp[i]) for every row i of xp, fp [..., n] (xp
	non-decreasing along a row), for the scalar x, as numpy computes it."""
	n = xp.shape[-1]
	if n == 1: return fp[..., 0].clone()
	q = torch.full(xp.shape[:-1] + (1,), float(x), dtype=xp.dtype, device=xp.device)
	j = torch.searchsorted(xp.contiguous(), q, right=True) - 1
	jc = j.clamp(0, n - 2)
	x0, x1 = torch.gather(xp, -1, jc), torch.gather(xp, -1, jc + 1)
	f0, f1 = torch.gather(fp, -1, jc), torch.gather(fp, -1, jc + 1)
	slope = (f1 - f0)/(x1 - x0)
	res = slope*(q - x0) + f0
	res = torch.where(torch.isnan(res), slope*(q - x1) + f1, res)
	res = torch.where(torch.isnan(res) & (f0 == f1), f0, res)
	res = torch.where(x0 == q, f0, res)
	res = torch.where(j >= n - 1, fp[..., -1:], res)
	res = torch.where(j < 0, fp[..., :1], res)
	return res[..., 0]


def weighted_quantile(map, ivar, quantile, axis=-1):
	"""The quantile of map along axis with the weights ivar: the value at
	which the weights' cumulative share, each weight counted to its middle,
	reaches quantile, interpolated linearly (float64; a tensor's on its
	device, its values sorted stably)."""
	if isinstance(map, torch.Tensor):
		map = map.to(torch.float64)
		ivar = torch.broadcast_to(torch.as_tensor(ivar, device=map.device).to(torch.float64), map.shape)
		m, order = torch.sort(map, dim=axis, stable=True)
		w = torch.take_along_dim(ivar, order, axis)
		cw = torch.cumsum(w, axis) - 0.5*w
		p = cw/torch.clamp(w.sum(axis, keepdim=True), min=1e-300)
		return _interp_rows(quantile, torch.movedim(p, axis, -1), torch.movedim(m, axis, -1))
	map = np.asarray(map, float)
	ivar = np.broadcast_to(np.asarray(ivar, float), map.shape)
	order = np.argsort(map, axis=axis)
	m = np.take_along_axis(map, order, axis)
	w = np.take_along_axis(ivar, order, axis)
	cw = np.cumsum(w, axis) - 0.5*w
	tot = np.sum(w, axis=axis, keepdims=True)
	p = cw/np.maximum(tot, 1e-300)
	m2 = np.moveaxis(m, axis, -1); p2 = np.moveaxis(p, axis, -1)
	flat_m = m2.reshape(-1, m2.shape[-1]); flat_p = p2.reshape(-1, p2.shape[-1])
	res = np.array([np.interp(quantile, pi, mi) for pi, mi in zip(flat_p, flat_m)])
	return res.reshape(m2.shape[:-1])


def weighted_median(map, ivar=1, axis=-1):
	"""weighted_quantile at 0.5."""
	return weighted_quantile(map, ivar, 0.5, axis=axis)


def _transpose(a, order):
	order = [int(o) for o in order]
	return a.permute(*order) if isinstance(a, torch.Tensor) else np.transpose(a, order)


def partial_flatten(a, axes=[-1], pos=0):
	"""a with every axis but axes flattened into one, placed at pos."""
	a = _array(a)
	axes = [ax % a.ndim for ax in axes]
	rest = [i for i in range(a.ndim) if i not in axes]
	a = _transpose(a, rest + axes)
	a = a.reshape((-1,) + tuple(a.shape[len(rest):]))
	return moveaxis(a, 0, pos)


def partial_expand(a, shape, axes=[-1], pos=0):
	"""The inverse of partial_flatten, for an array of the given shape."""
	a = _array(a)
	a = moveaxis(a, pos, 0)
	axes = [ax % len(shape) for ax in axes]
	rest = [i for i in range(len(shape)) if i not in axes]
	a = a.reshape(tuple(shape[i] for i in rest) + tuple(a.shape[1:]))
	return _transpose(a, np.argsort(rest + axes))


def addaxes(a, axes):
	"""a with new axes of length 1 at the positions axes (of the result)."""
	a = _array(a)
	for ax in sorted([ax % (a.ndim + len(axes)) for ax in axes]):
		a = a.unsqueeze(ax) if isinstance(a, torch.Tensor) else np.expand_dims(a, ax)
	return a


def delaxes(a, axes):
	"""a without its axes of length 1 at the positions axes."""
	a = _array(a)
	for ax in sorted([ax % a.ndim for ax in axes], reverse=True):
		a = a.squeeze(ax) if isinstance(a, torch.Tensor) else np.squeeze(a, ax)
	return a


class flatview:
	"""with flatview(arr, axes=[...]) as farr: farr is arr by
	partial_flatten, and with "w" in mode what was written to it goes back
	into arr on leaving (numpy arrays or tensors)."""
	def __init__(self, array, axes=[], mode="rwc", pos=0):
		self.array = array
		self.axes = axes
		self.pos = pos
		self.mode = mode
	def __enter__(self):
		self.flat = partial_flatten(self.array, self.axes, self.pos)
		return self.flat
	def __exit__(self, type, value, traceback):
		if "w" in self.mode:
			self.array[...] = partial_expand(self.flat, self.array.shape, self.axes, self.pos)


class nowarn:
	"""Silence warnings, and numpy's floating-point ones, in a with block."""
	def __enter__(self):
		import warnings
		self._cm = warnings.catch_warnings()
		self._cm.__enter__()
		warnings.simplefilter("ignore")
		self._err = np.seterr(all="ignore")
		return self
	def __exit__(self, type, value, traceback):
		np.seterr(**self._err)
		self._cm.__exit__(type, value, traceback)


def dedup(a):
	"""A 1d array without its consecutive repeats."""
	a = np.asarray(a)
	if a.size == 0: return a
	keep = np.concatenate([[True], a[1:] != a[:-1]])
	return a[keep]


def bin_multi(pix, shape, weights=None):
	"""The hits of the indices pix [{coords}, n], each clipped into shape,
	counted (or weights summed, float64) into an array of that shape: a
	tensor's on its device."""
	if isinstance(pix, torch.Tensor):
		flat = torch.zeros(pix.shape[1:], dtype=torch.int64, device=pix.device)
		for p, s in zip(pix, shape): flat = flat*int(s) + p.clamp(0, int(s) - 1)
		if weights is not None: weights = torch.as_tensor(weights, device=pix.device).to(torch.float64)
		return torch.bincount(flat, weights=weights, minlength=int(np.prod(shape))).reshape(tuple(shape))
	pix = np.asarray(pix)
	flat = np.ravel_multi_index([np.clip(p, 0, s-1) for p, s in zip(pix, shape)], shape)
	return np.bincount(flat, weights=weights, minlength=int(np.prod(shape))).reshape(shape)


def bincount(pix, weights=None, minlength=0):
	"""np.bincount over the last axis of pix [..., n] for each of its leading
	indices (float64 then, as the weights' sums always are): a tensor's on
	its device, by one torch.bincount of row-offset indices."""
	if isinstance(pix, torch.Tensor):
		w = None if weights is None else torch.as_tensor(weights, device=pix.device).to(torch.float64)
		if pix.ndim == 1 and (w is None or w.ndim == 1):
			return torch.bincount(pix, weights=w, minlength=minlength)
		pix2 = pix.reshape(-1, pix.shape[-1])
		n = max(minlength, int(pix.max())+1 if pix.numel() else minlength)
		rows = pix2.shape[0]
		off = pix2 + torch.arange(rows, device=pix.device)[:, None]*n
		if w is not None: w = torch.broadcast_to(w, pix.shape).reshape(-1)
		res = torch.bincount(off.reshape(-1), weights=w, minlength=rows*n).to(torch.float64)
		return res.reshape(pix.shape[:-1] + (n,))
	pix = np.asarray(pix)
	if pix.ndim == 1 and (weights is None or np.asarray(weights).ndim == 1):
		return np.bincount(pix, weights=weights, minlength=minlength)
	pix2 = pix.reshape(-1, pix.shape[-1])
	if weights is not None:
		w2 = np.broadcast_to(np.asarray(weights), pix.shape).reshape(pix2.shape)
	n = max(minlength, int(pix.max())+1 if pix.size else minlength)
	res = np.zeros(pix2.shape[:1] + (n,))
	for i in range(len(pix2)):
		res[i] = np.bincount(pix2[i], weights=w2[i] if weights is not None else None, minlength=n)
	return res.reshape(pix.shape[:-1] + (n,))


def grid(box, shape, endpoint=True, axis=0, flat=False):
	"""An evenly spaced grid of coordinates over box [{from, to}, ndim]:
	[ndim, *shape] (or [ndim, prod(shape)] with flat), axis 0 moved to axis."""
	box = np.asarray(box, float)
	ndim = box.shape[1] if box.ndim > 1 else 1
	box = box.reshape(2, ndim)
	axs = [np.linspace(box[0, i], box[1, i], shape[i], endpoint=endpoint) for i in range(ndim)]
	mesh = np.meshgrid(*axs, indexing="ij")
	res = np.stack(mesh, 0)
	if flat: res = res.reshape(ndim, -1)
	return np.moveaxis(res, 0, axis)


def pixwin_1d(f, order=0):
	"""The 1d pixel window at the frequencies f (cycles a pixel) of
	nearest-neighbour (order 0, "nn") or linear (1, "lin") mapmaking, 1 for
	None or "none"; a tensor's on its device."""
	xp = _xp(f)
	if xp is np: f = np.asarray(f)
	if order is None or order == "none": return f*0 + 1
	if order in (0, "nn"): return xp.sinc(f)
	if order in (1, "lin"):
		return xp.sinc(f)**2/((2 + xp.cos(2*np.pi*f))/3)
	raise ValueError("Unsupported order '%s'" % str(order))


# ---------------------------------------------------------------------------
# nearest_product, files and periods (pixell_tpu/utils.py:1417-1527), host
# ---------------------------------------------------------------------------
def nearest_product(n, factors, direction="below"):
	"""The largest product of powers of factors at most n ("below"), or the
	smallest at least n ("above")."""
	below = direction == "below"
	ni = floor(n) if below else ceil(n)
	if 1 in factors: return ni
	limit = ni + 1 if below else ni*min(factors) + 1
	reach = np.zeros(limit + 1, bool)
	reach[1] = True
	best = None
	for i in range(ni + 1):
		if not reach[i]: continue
		for f in factors:
			m = i*f
			if below:
				if m > n: continue
				best = m if best is None or m > best else best
			else:
				if m >= n and (best is None or m < best): best = m
			if m < reach.size: reach[m] = True
	return best


def mkdir(path):
	"""Make the directory path and its parents, where missing."""
	os.makedirs(path, exist_ok=True)


def symlink(src, dest):
	"""Make dest a symbolic link to src, replacing what dest was."""
	try: os.remove(dest)
	except FileNotFoundError: pass
	os.symlink(src, dest)


def decomp_basis(basis, vec):
	"""The least-squares coefficients of vec on the rows of basis."""
	basis = np.asarray(basis); vec = np.asarray(vec)
	return np.linalg.solve(basis @ basis.T, basis @ vec.T).T


def find_period_fourier(d, axis=-1):
	"""The period along axis of d, from the peak of its power spectrum
	(weighted over the peak and its neighbours)."""
	d = np.asarray(d)
	d2 = np.moveaxis(d, axis, -1)
	flat = d2.reshape(-1, d2.shape[-1])
	ps = np.abs(np.fft.rfft(flat))**2
	ps[:, 0] = 0
	res = np.empty(len(flat))
	for i, p in enumerate(ps):
		k = np.argmax(p[1:]) + 1
		ks = np.arange(max(1, k-1), min(len(p), k+2))
		kw = np.sum(ks*p[ks])/np.maximum(np.sum(p[ks]), 1e-300)
		res[i] = flat.shape[-1]/kw
	return res.reshape(d2.shape[:-1])


def find_period_exact(d, guess):
	"""(period, phase, chisq): the guess refined by fitting d folded at the
	period (Powell's method)."""
	from scipy import optimize
	d = np.asarray(d, float)
	n = d.size
	n = int(min(10, n/float(guess))*guess)
	off = (d.size - n)//2
	d = d[off:off+n]
	t = np.arange(n)
	def chisq(x):
		w, phase = x
		w = abs(w) + 1e-3
		ph = (t + phase) % w
		model = np.interp(ph, np.sort(ph), d[np.argsort(ph)])
		return np.var(d - model)
	res = optimize.fmin_powell(chisq, [guess, guess], xtol=1, disp=False)
	period, phase = res
	return period, phase + off, chisq([period, phase])/max(np.var(d**2), 1e-300)


def find_period(d, axis=-1):
	"""(periods, phases, chisqs) of the periodic signal d along axis."""
	d = np.asarray(d)
	dwork = partial_flatten(d, [axis])
	guess = np.atleast_1d(find_period_fourier(dwork))
	res = np.empty([3, len(dwork)])
	for i, (d1, g1) in enumerate(zip(dwork, guess)):
		res[:, i] = find_period_exact(d1, g1)
	oshape = d.shape[:axis % d.ndim] + d.shape[axis % d.ndim + 1:]
	return tuple(r.reshape(oshape) for r in res)


def find_sweeps(az, tol=0.2):
	"""[nsweep, {start, end}]: the monotonic sweeps of az, turns smaller than
	tol of its range left out."""
	az = np.asarray(az, float)
	d = np.sign(np.diff(az))
	turn = np.nonzero(np.diff(d) != 0)[0] + 1
	amp = (np.max(az) - np.min(az))
	bounds = [0]
	for t in turn:
		if abs(az[t] - az[bounds[-1]]) > tol*amp:
			bounds.append(t)
	bounds.append(len(az)-1)
	sweeps = [[bounds[i], bounds[i+1]] for i in range(len(bounds)-1) if bounds[i+1] > bounds[i]]
	return np.array(sweeps)


def equal_split(weights, nbin):
	"""The indices of weights in nbin groups of about equal sums (the
	largest first, each to the lightest group)."""
	order = np.argsort(weights)[::-1]
	sums = np.zeros(nbin)
	res = [[] for _ in range(nbin)]
	for i in order:
		j = np.argmin(sums)
		res[j].append(i)
		sums[j] += weights[i]
	return res


# ---------------------------------------------------------------------------
# Ranges [:, {from, to}] and bins (pixell_tpu/utils.py:1529-1626), host
# ---------------------------------------------------------------------------
def range_normalize(a):
	"""Ranges turned increasing, the empty ones dropped."""
	a = np.array(a)
	if a.size == 0: return a.reshape(0, 2)
	flip = a[:, 1] < a[:, 0]
	a[flip] = a[flip, ::-1]
	return a[a[:, 1] > a[:, 0]]


def range_union(a, mapping=False):
	"""Overlapping or touching ranges merged, in order of their starts; with
	mapping also the merged range each input went into."""
	a = np.asarray(a)
	if a.size == 0:
		return (a.reshape(0, 2), np.zeros(0, int)) if mapping else a.reshape(0, 2)
	order = np.argsort(a[:, 0])
	res = []
	omap = np.empty(len(a), int)
	for oi in order:
		r = a[oi]
		if res and r[0] <= res[-1][1]:
			res[-1][1] = max(res[-1][1], r[1])
		else:
			res.append([r[0], r[1]])
		omap[oi] = len(res) - 1
	res = np.array(res)
	return (res, omap) if mapping else res


def range_sub(a, b, mapping=False):
	"""The ranges a less the ranges b; with mapping (pieces, the range of a
	each piece came from, None): the third element is a placeholder, as in
	the reference."""
	a = np.asarray(a).reshape(-1, 2)
	b = range_union(np.asarray(b).reshape(-1, 2)) if len(b) else np.zeros((0, 2))
	out = []
	amap = []
	for ia, (a0, a1) in enumerate(a):
		cur = a0
		for b0, b1 in b:
			if b1 <= cur or b0 >= a1: continue
			if b0 > cur:
				out.append([cur, b0]); amap.append(ia)
			cur = max(cur, b1)
		if cur < a1:
			out.append([cur, a1]); amap.append(ia)
	out = np.array(out).reshape(-1, 2)
	if mapping: return out, np.asarray(amap, int), None
	return out


def range_cut(a, c):
	"""The ranges a cut at the positions c."""
	a = np.asarray(a).reshape(-1, 2)
	c = np.sort(np.asarray(c))
	out = []
	for a0, a1 in a:
		cs = c[(c > a0) & (c < a1)]
		edges = np.concatenate([[a0], cs, [a1]])
		for i in range(len(edges)-1):
			out.append([edges[i], edges[i+1]])
	return np.array(out).reshape(-1, 2)


def edges2bins(edges):
	"""Bin edges [nbin+1] as bins [nbin, {from, to}]."""
	edges = np.asarray(edges)
	return np.stack([edges[:-1], edges[1:]], -1)


def bins2edges(bins):
	"""Contiguous bins [nbin, {from, to}] as edges [nbin+1]."""
	bins = np.asarray(bins)
	return np.concatenate([bins[:, 0], bins[-1:, 1]])


def bin_expand(bins, bdata):
	"""Values a bin [..., nbin] as values a sample, each over its bin."""
	bins = np.asarray(bins); bdata = np.asarray(bdata)
	n = int(bins[-1, 1])
	res = np.zeros(bdata.shape[:-1] + (n,), bdata.dtype)
	for i, (b0, b1) in enumerate(bins):
		res[..., int(b0):int(b1)] = bdata[..., i, None]
	return res


def pad_bins(bins, pad, min=None, max=None):
	"""Bins widened by pad at either end, kept within [min, max] where given."""
	bins = np.array(bins)
	bins[:, 0] -= pad; bins[:, 1] += pad
	if min is not None: bins[:, 0] = np.maximum(bins[:, 0], min)
	if max is not None: bins[:, 1] = np.minimum(bins[:, 1], max)
	return bins


def merge_bins(bins):
	"""Overlapping bins merged (range_union)."""
	return range_union(bins)


def infer_bin_edges(centers, ref=1):
	"""Bin edges whose bins are centred on centers, bins ref and ref+1 of
	equal width."""
	c = np.asarray(centers, float)
	n = len(c)
	A = np.zeros((n+1, n+1))
	rhs = np.zeros(n+1)
	for i in range(n):
		A[i, i] = A[i, i+1] = 0.5
		rhs[i] = c[i]
	A[n, ref] = -1; A[n, ref+1] = 1
	rhs[n] = c[ref+1] - c[ref]
	return np.linalg.solve(A, rhs)


# ---------------------------------------------------------------------------
# Boxes [{from, to}, ndim] and positions (pixell_tpu/utils.py:1630-1743), host
# but for sum_by_id and resize_array, which take tensors too
# ---------------------------------------------------------------------------
def bounding_box(boxes):
	"""The bounding box of boxes [:, 2, ndim] or of points [:, ndim]."""
	boxes = np.asarray(boxes)
	if boxes.ndim == 2:
		return np.array([boxes.min(0), boxes.max(0)])
	return np.array([boxes.min((0, 1)), boxes.max((0, 1))])


def box2corners(box):
	"""The 2^ndim corners of box [{from, to}, ndim]."""
	box = np.asarray(box)
	ndim = box.shape[1]
	out = []
	for i in range(2**ndim):
		out.append([box[(i >> d) & 1, d] for d in range(ndim)])
	return np.array(out)


def box2contour(box, nperedge=5):
	"""Points along the edges of a 2d box, nperedge an edge, once around."""
	box = np.asarray(box, float)
	n = np.zeros(2, int) + nperedge
	ys = np.linspace(box[0, 0], box[1, 0], n[0])
	xs = np.linspace(box[0, 1], box[1, 1], n[1])
	pts = ([[y, box[0, 1]] for y in ys] + [[box[1, 0], x] for x in xs[1:]] +
		[[y, box[1, 1]] for y in ys[::-1][1:]] + [[box[0, 0], x] for x in xs[::-1][1:-1]])
	return np.array(pts)


def box_area(a):
	"""The (unsigned) area of boxes [..., {from, to}, ndim]."""
	a = np.asarray(a)
	return np.abs(np.prod(a[..., 1, :] - a[..., 0, :], -1))


def box_slice(a, b):
	"""The part of box b within box a, relative to a's first corner."""
	a = np.asarray(a); b = np.asarray(b)
	pre = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
	a2 = np.broadcast_to(a, pre + a.shape[-2:])
	b2 = np.broadcast_to(b, pre + b.shape[-2:])
	lo = np.maximum(a2[..., 0, :], b2[..., 0, :]) - a2[..., 0, :]
	hi = np.minimum(a2[..., 1, :], b2[..., 1, :]) - a2[..., 0, :]
	hi = np.maximum(lo, hi)
	return np.stack([lo, hi], -2)


def box_overlap(a, b):
	"""The area boxes a and b share."""
	s = box_slice(a, b)
	return np.abs(np.prod(s[..., 1, :] - s[..., 0, :], -1))


def pad_box(box, padding):
	"""A box padded by padding on either side, in the direction it runs."""
	box = np.array(box, float)
	sgn = np.where(box[1] >= box[0], 1, -1)
	box[0] -= padding*sgn
	box[1] += padding*sgn
	return box


def unwrap_range(range_, nwrap=2*np.pi):
	"""A range [{from, to}, ...] with to moved by whole periods nwrap to just
	above from, then both to the period below."""
	range_ = np.array(range_, float)
	range_[1] -= np.floor((range_[1] - range_[0])/nwrap)*nwrap
	range_ -= np.floor(range_[1][None]/nwrap)*nwrap if range_.ndim > 1 else \
		np.floor(range_[1]/nwrap)*nwrap
	return range_


def sum_by_id(a, ids, axis=0):
	"""The sums of a's slices along axis that share an id (0 .. max(ids)):
	a tensor's on its device (index_add_)."""
	if isinstance(a, torch.Tensor):
		a = torch.movedim(a, axis, 0)
		ids = torch.as_tensor(ids, device=a.device).to(torch.int64)
		n = int(ids.max()) + 1 if ids.numel() else 0
		res = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device).index_add_(0, ids, a)
		return torch.movedim(res, 0, axis)
	a = np.moveaxis(np.asarray(a), axis, 0)
	ids = np.asarray(ids)
	n = int(ids.max()) + 1 if ids.size else 0
	res = np.zeros((n,) + a.shape[1:], a.dtype)
	np.add.at(res, ids, a)
	return np.moveaxis(res, 0, axis)


def pole_wrap(pos):
	"""Positions [{lat, lon}, ...] past a pole mirrored back into [-pi/2,
	pi/2], pi added to the longitude for each mirroring."""
	pos = np.array(pos)
	lat, lon = pos[0], pos[1]
	halforbit = np.floor((lat + np.pi/2)/np.pi).astype(int)
	back = halforbit % 2 != 0
	lat = lat - np.pi*halforbit
	lat = np.where(back, -lat, lat)
	lon = np.where(back, lon + np.pi, lon)
	pos[0], pos[1] = lat, lon
	return pos


def tuplify(a):
	"""a as a tuple, (a,) if it is not iterable."""
	try: return tuple(a)
	except TypeError: return (a,)


def iorlast(a, i):
	"""a[i], or a's last element past its end, or a itself if not a sequence."""
	try: return a[min(i, len(a)-1)]
	except TypeError: return a


def resize_array(arr, size, axis=None, val=0):
	"""arr cut or padded with val to the sizes size along axis (the first
	ones by default): a tensor's on its device."""
	arr = _array(arr)
	sizes = np.atleast_1d(size)
	axes = range(len(sizes)) if axis is None else np.atleast_1d(axis)
	oshape = list(arr.shape)
	for ax, s in zip(axes, sizes): oshape[ax] = int(s)
	if isinstance(arr, torch.Tensor): res = torch.full(oshape, val, dtype=arr.dtype, device=arr.device)
	else: res = np.full(oshape, val, arr.dtype)
	sel = tuple(slice(0, min(o, n)) for o, n in zip(arr.shape, oshape))
	res[sel] = arr[sel]
	return res


# ---------------------------------------------------------------------------
# gcd ... minmax (pixell_tpu/utils.py:1783-1950): vec_angdist, rescale and
# minmax take tensors too; the rest is host code
# ---------------------------------------------------------------------------
def gcd(a, b):
	"""The greatest common divisor of two integers."""
	while b: a, b = b, a % b
	return a


def lcm(a, b):
	"""The least common multiple of two integers."""
	return a*b//gcd(a, b)


def uncat(a, lens):
	"""a split into consecutive pieces of the lengths lens."""
	cuts = np.concatenate([[0], np.cumsum(lens)])
	return [a[cuts[i]:cuts[i+1]] for i in range(len(lens))]


def vec_angdist(v1, v2, axis=0):
	"""The angle between the vectors v1 and v2 (along axis), by the
	formula 2 atan(|a - b|/|a + b|) of the unit vectors, exact at small and
	large angles; float64, a tensor's on its device."""
	if isinstance(v1, torch.Tensor) or isinstance(v2, torch.Tensor):
		dev = (v1 if isinstance(v1, torch.Tensor) else v2).device
		v1 = torch.as_tensor(v1, device=dev).to(torch.float64)
		v2 = torch.as_tensor(v2, device=dev).to(torch.float64)
		# numpy's norm, sqrt(sum(x x)), along axis where the vectors lie
		norm = lambda x, keepdim=False: torch.sqrt((x*x).sum(axis, keepdim=keepdim))
		a, b = v1/norm(v1, True), v2/norm(v2, True)
		return 2*torch.atan2(norm(a - b), norm(a + b))
	v1 = np.asarray(v1, float); v2 = np.asarray(v2, float)
	n1 = np.linalg.norm(v1, axis=axis); n2 = np.linalg.norm(v2, axis=axis)
	a = np.moveaxis(v1, axis, -1)/n1[..., None]
	b = np.moveaxis(v2, axis, -1)/n2[..., None]
	return 2*np.arctan2(np.linalg.norm(a - b, axis=-1), np.linalg.norm(a + b, axis=-1))


def label_unique(a, axes=(), rtol=1e-5, atol=1e-8):
	"""A label for each entry of a over the axes not in axes (the rest of
	an entry's values along axes), equal for entries np.allclose to each
	other, in order of first appearance."""
	a = np.asarray(a)
	axes = tuple(ax % a.ndim for ax in axes)
	rest = tuple(i for i in range(a.ndim) if i not in axes)
	work = np.transpose(a, rest + axes).reshape((-1,) + tuple(a.shape[i] for i in axes))
	labels = np.full(len(work), -1, int)
	nlab = 0
	for i in range(len(work)):
		if labels[i] >= 0: continue
		same = np.ones(len(work), bool)
		for j in range(len(work)):
			same[j] = labels[j] < 0 and np.allclose(work[j], work[i], rtol=rtol, atol=atol)
		labels[same] = nlab
		nlab += 1
	return labels.reshape(tuple(a.shape[i] for i in rest))


def transpose_inds(inds, nrow, ncol):
	"""The flat indices of an (nrow, ncol) array's entries in its transpose."""
	inds = np.asarray(inds)
	r, c = np.unravel_index(inds, (nrow, ncol))
	return np.ravel_multi_index((c, r), (ncol, nrow))


def rescale(a, range=[0, 1]):
	"""a mapped linearly from [min, max] onto range (range[0] everywhere for
	a constant a); float64, a tensor's on its device."""
	if isinstance(a, torch.Tensor):
		a = a.to(torch.float64)
		mn, mx = a.min(), a.max()
		if bool(mx == mn): return torch.full_like(a, range[0])
		return (a - mn)/(mx - mn)*(range[1] - range[0]) + range[0]
	a = np.asarray(a, float)
	mn, mx = a.min(), a.max()
	if mx == mn: return np.full_like(a, range[0])
	return (a - mn)/(mx - mn)*(range[1] - range[0]) + range[0]


def split_by_group(a, start, end):
	"""The string a split into alternating sections outside and inside
	bracket groups (opened by a character of start, closed by one of end)."""
	res = [""]
	depth = 0
	for ch in a:
		if depth == 0 and ch in start:
			depth = 1
			res.append(ch)
		elif depth > 0:
			res[-1] += ch
			if ch in start: depth += 1
			elif ch in end:
				depth -= 1
				if depth == 0: res.append("")
		else:
			res[-1] += ch
	return res


def split_outside(a, sep, start="([{", end=")]}"):
	"""The string a split at sep where it is outside brackets."""
	res = [""]
	depth = 0
	for ch in a:
		if ch in start: depth += 1
		elif ch in end: depth -= 1
		if ch == sep and depth == 0:
			res.append("")
		else:
			res[-1] += ch
	return res


def replace_outside(pattern, repl, string, start="([{", end=")]}"):
	"""re.sub(pattern, repl) on the parts of string outside brackets."""
	parts = []
	depth = 0
	cur = ""
	for ch in string:
		if ch in start:
			if depth == 0:
				parts.append(("out", cur)); cur = ""
			depth += 1
			cur += ch
		elif ch in end:
			depth -= 1
			cur += ch
			if depth == 0:
				parts.append(("in", cur)); cur = ""
		else:
			cur += ch
	parts.append(("out" if depth == 0 else "in", cur))
	return "".join(re.sub(pattern, repl, t) if kind == "out" else t for kind, t in parts)


def find_similar_groups_fast(vals, tol=0):
	"""(ngroup, order, edges): the groups of a 1d array's sorted values,
	a new one wherever the step exceeds tol."""
	vals = np.asarray(vals)
	order = np.argsort(vals, kind="stable")
	sv = vals[order]
	new = np.concatenate([[True], np.diff(sv) > tol])
	cut = np.nonzero(new)[0]
	edges = np.concatenate([cut, [len(sv)]])
	return len(cut), order, edges


def label_similar_groups_fast(vals, tol=0):
	"""The group of find_similar_groups_fast each value falls in."""
	n, order, edges = find_similar_groups_fast(vals, tol=tol)
	labels = np.empty(len(np.asarray(vals)), int)
	for gi in range(n):
		labels[order[edges[gi]:edges[gi+1]]] = gi
	return labels


def label_multi(valss, return_index=False, return_nlabel=False):
	"""A label for each position of the key arrays valss, equal where all
	keys are, in order of first appearance; with return_index the first
	position of each label, with return_nlabel their count."""
	keys = list(zip(*[np.asarray(v).tolist() for v in valss]))
	seen = {}
	index = []
	labels = np.empty(len(keys), int)
	for i, k in enumerate(keys):
		if k not in seen:
			seen[k] = len(seen)
			index.append(i)
		labels[i] = seen[k]
	res = (labels,)
	if return_index: res = res + (np.array(index),)
	if return_nlabel: res = res + (len(seen),)
	return res[0] if len(res) == 1 else res


def pathsplit(path):
	"""Every component of a path, in order."""
	parts = []
	while True:
		head, tail = os.path.split(path)
		if tail: parts.append(tail)
		elif head:
			parts.append(head)
			break
		if not head: break
		path = head
	return parts[::-1]


def minmax(a, axis=None):
	"""[min, max] of a (along axis): a tensor's stacked on its device."""
	if isinstance(a, torch.Tensor):
		if axis is None: return torch.stack([a.min(), a.max()])
		return torch.stack([a.amin(axis), a.amax(axis)])
	a = np.asarray(a)
	return np.array([a.min(axis=axis), a.max(axis=axis)])


# ---------------------------------------------------------------------------
# rewind_compact ... combine_beams (pixell_tpu/utils.py:1954-2068): deslope
# and the covariance helpers take tensors too
# ---------------------------------------------------------------------------
def rewind_compact(phis, period=2*np.pi, axis=-1):
	"""The angles phis rewound onto the most compact interval, for each
	slice along axis. The reference leaves the reference angles without
	that axis, which then broadcast against the wrong one or not at all
	(pixell_tpu/utils.py:1958, ROADMAP Queue 3)."""
	ref = find_rewind_compact_ref(phis, period=period, axis=axis)
	if np.ndim(phis) > 1 and np.shape(phis)[axis] > 0: ref = np.expand_dims(ref, axis)
	return rewind(phis, ref, period=period)


def find_rewind_compact_ref(phis, period=2*np.pi, axis=-1):
	"""The reference angle that makes phis rewound most compact: the middle
	of their largest gap, plus half a period."""
	phis = np.asarray(rewind(phis, ref=0, period=period))
	if phis.shape[axis] == 0: return phis
	sp = np.sort(phis, axis=axis)
	first = np.take(sp, [0], axis=axis) + period
	sp = np.concatenate([sp, first], axis=axis)
	gaps = np.diff(sp, axis=axis)
	icut = np.argmax(gaps, axis=axis)
	icut_k = np.expand_dims(icut, axis)
	mid = (np.take_along_axis(sp, icut_k, axis=axis) + np.take_along_axis(sp, icut_k+1, axis=axis))/2
	return np.asarray(rewind(np.squeeze(mid, axis) + period/2, period=period))


def deslope(d, w=1, inplace=False, axis=-1, avg=np.mean):
	"""d less, along axis, the line through the averages (avg) of its first
	and last w samples; float64 unless inplace. The reference leaves d as
	it was for an axis whose rows its reshape copies (pixell_tpu/utils.py:1981,
	ROADMAP Queue 3): here every row is taken out. A tensor on its device,
	in one pass where avg is the mean."""
	if isinstance(d, torch.Tensor):
		if not inplace: d = d.to(torch.float64, copy=True)
		d2 = torch.movedim(d, axis, -1)
		n = d2.shape[-1]
		t = torch.arange(n, dtype=d.dtype, device=d.device)
		den = torch.tensor(float(max(n - 1, 1)), dtype=d.dtype, device=d.device)
		if avg is np.mean or avg is torch.mean:
			a0, a1 = d2[..., :w].mean(-1, keepdim=True), d2[..., -w:].mean(-1, keepdim=True)
			d2 -= t*(a1 - a0)/den + a0
			return d
		rows = [d2[idx] for idx in np.ndindex(*d2.shape[:-1])]
	else:
		d = np.asarray(d, float) if not inplace else d
		if not inplace: d = d.copy()
		d2 = np.moveaxis(d, axis, -1)
		t = np.arange(d2.shape[-1])
		den = max(d2.shape[-1] - 1, 1)
		rows = [d2[idx] for idx in np.ndindex(*d2.shape[:-1])]
	for row in rows:
		a0 = avg(row[:w]); a1 = avg(row[-w:])
		row -= t*(a1 - a0)/den + a0
	return d


def hasoff(val, off, tol=1e-6):
	"""Whether val lies within tol of an integer plus off."""
	return np.abs((val - off + 0.5) % 1 - 0.5) < tol


def same_array(a, b):
	"""Whether a and b are views of the same memory with the same layout."""
	a = np.asarray(a); b = np.asarray(b)
	return a.__array_interface__["data"] == b.__array_interface__["data"] \
		and a.shape == b.shape and a.strides == b.strides and a.dtype == b.dtype


def fix_zero_strides(a):
	"""a, copied into contiguous memory if an axis of length 1 has stride 0."""
	a = np.asarray(a)
	if all(s != 0 or n != 1 for s, n in zip(a.strides, a.shape)): return a
	return np.ascontiguousarray(a)


def greedy_split(data, n=2, costfun=max, workfun=lambda w, x: x if w is None else x + w):
	"""The indices of data in n groups, each item (the costliest first) put
	where costfun of the group's work (workfun) grows least."""
	order = np.argsort([costfun([workfun(None, d)]) for d in data])[::-1]
	groups = [[] for _ in range(n)]
	works = [None]*n
	for i in order:
		costs = [costfun([workfun(works[j], data[i])]) for j in range(n)]
		j = int(np.argmin(costs))
		groups[j].append(int(i))
		works[j] = workfun(works[j], data[i])
	return groups


def greedy_split_simple(data, n=2):
	"""data's values in n lists of about equal sums, the largest first."""
	order = np.argsort(data)[::-1]
	sums = np.zeros(n)
	res = [[] for _ in range(n)]
	for i in order:
		j = int(np.argmin(sums))
		res[j].append(data[int(i)])
		sums[j] += data[int(i)]
	return res


def cov2corr(C):
	"""(corr, std): the covariances C [..., n, n] as correlations and
	standard deviations; a tensor's on its device."""
	if isinstance(C, torch.Tensor):
		std = torch.sqrt(torch.abs(torch.diagonal(C, dim1=-2, dim2=-1)))
	else:
		C = np.asarray(C)
		std = np.sqrt(np.abs(np.einsum("...ii->...i", C)))
	corr = C/(std[..., :, None]*std[..., None, :])
	return corr, std


def corr2cov(corr, std):
	"""The inverse of cov2corr."""
	corr, std = _array(corr), _array(std)
	return corr*std[..., :, None]*std[..., None, :]


def eigsort(A, nmax=None, merged=False):
	"""(E, V), the eigenvalues and eigenvectors of the symmetric A, largest
	first, the first nmax of them; with merged V sqrt(E). A tensor's on its
	device (eigenvectors up to sign, as eigh's)."""
	if isinstance(A, torch.Tensor):
		E, V = _eigh(A)
		order = torch.flip(torch.argsort(E, dim=-1, stable=True), [-1])
		E = torch.take_along_dim(E, order, -1)
		V = torch.take_along_dim(V, order[..., None, :], -1)
	else:
		E, V = np.linalg.eigh(np.asarray(A))
		order = np.argsort(E)[..., ::-1]
		E = np.take_along_axis(E, order, -1)
		V = np.take_along_axis(V, order[..., None, :], -1)
	if nmax is not None:
		E = E[..., :nmax]; V = V[..., :nmax]
	if merged: return V*E[..., None, :]**0.5
	return E, V


def nodiag(A):
	"""A copy of A [..., n, n] with its diagonal zeroed."""
	if isinstance(A, torch.Tensor):
		A = A.clone()
		torch.diagonal(A, dim1=-2, dim2=-1).zero_()
		return A
	A = np.array(A)
	np.einsum("...ii->...i", A)[...] = 0
	return A


def unpackbits(a):
	"""The bits of a's bytes, most significant first."""
	return np.unpackbits(np.atleast_1d(np.asarray(a, np.uint8)))


def combine_beams(irads_array):
	"""The inverse-covariance triplet of the elliptical beam that convolving
	by each of irads_array's beams gives."""
	Cs = np.array([[[ir[0], ir[2]], [ir[2], ir[1]]] for ir in irads_array])
	Ctot = np.eye(2)
	for C in Cs:
		E, V = np.linalg.eigh(C)
		B = (V*np.maximum(E, 0)[None]**0.5) @ V.T
		Ctot = B @ Ctot @ B.T
	return np.array([Ctot[0, 0], Ctot[1, 1], Ctot[0, 1]])


# ---------------------------------------------------------------------------
# Shapes (pixell_tpu/utils.py:2070-2170): everything but read_lines takes a
# tensor too and keeps it on its device
# ---------------------------------------------------------------------------
def read_lines(fname, col=0):
	"""The lines of a file, selected by a slice written after a colon in its
	name ("file:10:20"); col is accepted and ignored, as in the reference."""
	toks = fname.split(":")
	fname, sel = toks[0], ":".join(toks[1:])
	with open(fname, "r") as f:
		lines_ = [line.rstrip("\n") for line in f]
	if sel:
		lines_ = eval("lines_[" + sel + "]")
	return lines_


def atleast_3d(a):
	"""a with axes of length 1 put in front up to 3 dimensions."""
	a = _array(a)
	while a.ndim < 3: a = a[None]
	return a


def atleast_Nd(a, n):
	"""a with axes of length 1 put in front up to n dimensions."""
	a = _array(a)
	while a.ndim < n: a = a[None]
	return a


def to_Nd(a, n, axis=0, return_inverse=False):
	"""a reshaped to n dimensions: axes of length 1 added in front (axis 0)
	or at the end (any other axis), or the leading (axis 0) or trailing
	axes merged; with return_inverse also a's shape. As in the reference,
	only whether axis is 0 matters."""
	a = _array(a)
	ishape = tuple(a.shape)
	if a.ndim < n:
		pads = n - a.ndim
		shape = (1,)*pads + ishape if axis == 0 else ishape + (1,)*pads
		res = a.reshape(shape)
	else:
		extra = a.ndim - n + 1
		if axis == 0:
			res = a.reshape((-1,) + ishape[extra:])
		else:
			res = a.reshape(ishape[:n-1] + (-1,))
	return (res, ishape) if return_inverse else res


def preflat(a, n):
	"""a with its first n axes flattened into one."""
	a = _array(a)
	if n < 0: n = a.ndim + n
	return a.reshape((-1,) + tuple(a.shape[n:]))


def postflat(a, n):
	"""a with its last n axes flattened into one."""
	a = _array(a)
	if n < 0: n = a.ndim + n
	return a.reshape(tuple(a.shape[:a.ndim-n]) + (-1,))


def blockify(a, bsize):
	"""a [..., nsamp] as blocks [..., nblock, bsize], the tail left out."""
	a = _array(a)
	nb = a.shape[-1]//bsize
	return a[..., :nb*bsize].reshape(tuple(a.shape[:-1]) + (nb, bsize))


def block_mean_filter(a, width):
	"""A float64 copy of a with each of the n//width blocks of its last axis
	(edges at linspace(0, n, nblock+1)) replaced by its mean."""
	a = a.to(torch.float64, copy=True) if isinstance(a, torch.Tensor) else np.array(a, float)
	n = a.shape[-1]
	nb = max(n//int(width), 1)
	edges = np.linspace(0, n, nb+1).astype(int)
	for i in range(nb):
		blk = a[..., edges[i]:edges[i+1]]
		a[..., edges[i]:edges[i+1]] = blk.mean(-1, keepdim=True) if isinstance(a, torch.Tensor) else \
			np.mean(blk, -1)[..., None]
	return a


def tofinite(arr, val=0):
	"""arr with its non-finite values replaced by val (a float tensor's in
	one pass of nan_to_num)."""
	if isinstance(arr, torch.Tensor):
		if arr.is_floating_point(): return torch.nan_to_num(arr, nan=val, posinf=val, neginf=val)
		return torch.where(torch.isfinite(arr), arr, val)
	return np.where(np.isfinite(arr), arr, val)


def remove_nan(a):
	"""a with its NaN and infinite values set to 0, in place; returns a."""
	if isinstance(a, torch.Tensor): return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0, out=a)
	np.nan_to_num(a, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
	return a


def without_nan(a):
	"""A copy of a with its NaN and infinite values 0."""
	if isinstance(a, torch.Tensor): return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
	return np.nan_to_num(np.asarray(a), nan=0.0, posinf=0.0, neginf=0.0)


# ---------------------------------------------------------------------------
# Parsing, waves and physics (pixell_tpu/utils.py:2172-2263): triangle_wave
# and gnfw take tensors too
# ---------------------------------------------------------------------------
def parse_ints(s): return parse_numbers(s, int)
def parse_floats(s): return parse_numbers(s, float)


def parse_numbers(s, dtype=None):
	"""Numbers written as "1,2:5,8:10:0.5": values and from:to[:step] ranges."""
	res = []
	for tok in s.split(","):
		parts = tok.split(":")
		if len(parts) == 1:
			res.append(float(parts[0]))
		else:
			a_, b_ = float(parts[0]), float(parts[1])
			step = float(parts[2]) if len(parts) > 2 else 1
			res.extend(np.arange(a_, b_, step).tolist())
	res = np.array(res)
	if dtype is not None: res = res.astype(dtype)
	return res


def parse_box(desc):
	"""A box written "from:to,from:to,..." as [{from, to}, ndim]."""
	pairs = [[float(v) for v in tok.split(":")] for tok in desc.split(",")]
	return np.array(pairs).T


def triangle_wave(x, period=1):
	"""The triangle wave of amplitude 1 and the given period (0 at 0,
	rising); float64, a tensor's on its device."""
	if isinstance(x, torch.Tensor):
		x = x.to(torch.float64)
		x = x/torch.tensor(float(period), dtype=x.dtype, device=x.device)*4
		x = (x + 1) % 4 - 1
		return torch.where(x > 1, 2 - x, x)
	x = np.asarray(x, float)/period*4
	x = (x + 1) % 4 - 1
	return np.where(x > 1, 2 - x, x)


def type2_wave(x, period=1, amp=np.pi/2, mid=0, tol=1e-12):
	"""The scan wave log(tan(y/2)) of the triangle wave y of amplitude amp
	about pi/2 + mid."""
	y = triangle_wave(x, period=period)*amp + (np.pi/2 + mid)
	y = np.clip(np.abs(rewind(y)), tol, np.pi - tol)
	return np.log(np.tan(y/2))


def iplanck_T(f, I):
	"""The temperature at which the Planck spectrum at f is I."""
	return h*f/(k*np.log(1 + 2*h*f**3/(I*c**2)))


def noise_flux_factor(beam_area, freq, T0=T_cmb):
	"""The factor from white noise in K sqrt(sr) to a flux uncertainty in Jy."""
	sq_area = beam_area/2
	return dplanck(freq, T0)*sq_area**0.5*1e26


def gnfw(x, xc, alpha, beta, gamma):
	"""The generalized NFW profile (x/xc)^gamma (1 + (x/xc)^alpha)^((beta -
	gamma)/alpha); float64, a tensor's on its device."""
	x = x.to(torch.float64) if isinstance(x, torch.Tensor) else np.asarray(x, float)
	return (x/xc)**gamma*(1 + (x/xc)**alpha)**((beta - gamma)/alpha)


def tsz_profile_los_exact(x, xc=0.497, alpha=1.0, beta=-4.65, gamma=-0.3, zmax=1e5, _a=8):
	"""The line-of-sight integral of gnfw at projected radii x by adaptive
	quadrature (z = sinh(_a u)/_a), slow and exact. A scalar x gives a
	scalar, which the reference meant and does not do (it gives shape (1,);
	ROADMAP Queue 3)."""
	from scipy import integrate
	scalar = np.ndim(x) == 0
	x = np.atleast_1d(np.asarray(x, float))
	res = np.empty(x.shape)
	for i, xi in enumerate(x.reshape(-1)):
		def integrand(u):
			z = np.sinh(_a*u)/_a
			r = np.sqrt(xi**2 + z**2)
			return gnfw(r, xc, alpha, beta, gamma)*np.cosh(_a*u)
		umax = np.arcsinh(zmax*_a)/_a
		val, _ = integrate.quad(integrand, 0, umax, limit=200)
		res.reshape(-1)[i] = 2*val
	return res[0] if scalar else res


def tsz_tform(r200=1*arcmin, l=None, lmax=40000, xc=0.497, alpha=1.0, beta=4.65, gamma=-0.3, zmax=1e5):
	"""b(l) of the tSZ gNFW profile of angular size r200 (tsz_profile_los
	through profile_to_tform_hankel), at l or at 0 .. lmax."""
	from scipy import interpolate
	lvals, bvals = profile_to_tform_hankel(lambda r: tsz_profile_los(
		r/r200, xc=xc, alpha=alpha, beta=beta, gamma=gamma, zmax=zmax))
	if l is None: l = np.arange(lmax+1)
	return interpolate.interp1d(np.log(lvals), bvals, "cubic")(np.log(np.maximum(l, np.min(lvals))))


def is_int_valued(a):
	"""Whether every value of a is a whole number."""
	a = np.asarray(a)
	return np.all(a == np.floor(a))


# ---------------------------------------------------------------------------
# Bases and linear operators (pixell_tpu/utils.py:2265-2322): matvec takes
# tensors too
# ---------------------------------------------------------------------------
def build_legendre(x, nmax):
	"""The Legendre polynomials P_0 .. P_nmax-1 of x rescaled onto [-1, 1]."""
	x = np.asarray(x, float)
	if x.size > 1:
		x = (x - x.min())/(x.max() - x.min())*2 - 1
	res = np.empty((nmax,) + x.shape)
	if nmax > 0: res[0] = 1
	if nmax > 1: res[1] = x
	for i in range(2, nmax):
		res[i] = ((2*i - 1)*x*res[i-1] - (i - 1)*res[i-2])/i
	return res


def build_cossin(x, nmax):
	"""The basis [sin x, cos x, sin 2x, cos 2x, ...] of nmax functions."""
	x = np.asarray(x, float)
	res = np.empty((nmax,) + x.shape)
	for i in range(nmax):
		kk = i//2 + 1
		res[i] = np.sin(kk*x) if i % 2 == 0 else np.cos(kk*x)
	return res


def uvec(n, i, dtype=np.float64):
	"""The unit vector along i in n dimensions."""
	res = np.zeros(n, dtype)
	res[i] = 1
	return res


def ubash(Afun, n, idtype=np.float64, odtype=None):
	"""The matrix of the linear operator Afun on n-vectors, a column a unit
	vector."""
	cols = []
	for i in range(n):
		cols.append(np.asarray(Afun(uvec(n, i, idtype))))
	A = np.stack(cols, -1)
	return A.astype(odtype) if odtype is not None else A


def matvec(A, x):
	"""A [..., a, b] times x [..., b]: a tensor's on its device."""
	if isinstance(A, torch.Tensor) or isinstance(x, torch.Tensor):
		dev = (A if isinstance(A, torch.Tensor) else x).device
		return torch.einsum("...ab,...b->...a", torch.as_tensor(A, device=dev), torch.as_tensor(x, device=dev))
	return np.einsum("...ab,...b->...a", A, x)


def build_conditional(ps, inds, axes=[0, 1]):
	"""(A, cov): for the Gaussian of covariance ps (its matrix axes axes),
	the unknown components' mean A x_known and covariance given the known
	ones at inds."""
	ps = np.asarray(ps)
	C = partial_flatten(ps, axes)
	known = np.zeros(C.shape[1], bool)
	known[inds] = True
	unknown = ~known
	def safe_inv(M):
		good = ~np.all(np.einsum("aii->ai", M) == 0, -1)
		res = np.zeros_like(M)
		if good.any(): res[good] = np.linalg.inv(M[good])
		return res
	Ci = safe_inv(C)
	Ciuk = Ci[:, unknown][:, :, known]
	Ciuu = Ci[:, unknown][:, :, unknown]
	Ciuui = safe_inv(Ciuu)
	A = -np.matmul(Ciuui, Ciuk)
	return A, Ciuui


# ---------------------------------------------------------------------------
# Tables, iterators and slices (pixell_tpu/utils.py:2324-2407):
# slice_downgrade takes tensors too
# ---------------------------------------------------------------------------
def load_ascii_table(fname, desc, sep=None, dsep=None):
	"""A text table as a record array, its columns "name:type" in desc
	(split by dsep; "|" skips a column), rows split by sep, # comments out."""
	fields = desc.split(dsep)
	names, typs, keep = [], [], []
	for i, f in enumerate(fields):
		if f == "|": continue
		name, typ = f.split(":")
		names.append(name); typs.append(typ); keep.append(i)
	rows = []
	for line in lines(fname):
		line = line.strip()
		if not line or line.startswith("#"): continue
		toks = line.split(sep)
		rows.append(tuple(toks[i] for i in keep))
	dtype = [(n, t) for n, t in zip(names, typs)]
	return np.array(rows, dtype=dtype).view(np.recarray)


def count_variable_basis(bases):
	"""Every digit list of a counter whose digit i counts to bases[i], the
	last digit fastest."""
	n = len(bases)
	cur = [0]*n
	while True:
		yield list(cur)
		i = n - 1
		while i >= 0:
			cur[i] += 1
			if cur[i] < bases[i]: break
			cur[i] = 0
			i -= 1
		else:
			return


def list_combination_iter(ilist):
	"""Every choice of one value from each list of ilist."""
	for digits in count_variable_basis([len(l) for l in ilist]):
		yield [l[d] for l, d in zip(ilist, digits)]


def split_slice_simple(sel, ndims):
	"""A selection tuple split into consecutive groups of ndims entries."""
	res = []
	i = 0
	for n in ndims:
		res.append(tuple(sel[i:i+n]))
		i += n
	return res


def slice_downgrade(d, s, axis=-1):
	"""d sliced along axis by s, the step taken as the size of blocks
	averaged; a tensor's on its device."""
	d = moveaxis(_array(d), axis, 0)
	start = s.start or 0
	stop = s.stop if s.stop is not None else d.shape[0]
	step = s.step or 1
	d = d[start:stop]
	if step > 1:
		nb = d.shape[0]//step
		if isinstance(d, torch.Tensor): d = _float64(d)
		d = d[:nb*step].reshape((nb, step) + tuple(d.shape[1:])).mean(1)
	return moveaxis(d, 0, axis)


def unflatten_slice(sel, shape):
	"""The index arrays into shape of the flat selection sel."""
	inds = np.arange(int(np.prod(shape)))[sel]
	return np.unravel_index(inds, shape)


def outer_stack(arrays):
	"""[len(arrays), ...]: the open grid of arrays, stacked."""
	mesh = np.meshgrid(*arrays, indexing="ij")
	return np.stack(mesh, 0)


def tform_to_profile(bl, theta, normalize=False):
	"""The real-space profile at the angles theta of the harmonic transform
	b(l) (curvedsky.harm2profile), normalized to 1 at theta[0] if asked."""
	from .curvedsky import harm2profile
	br = harm2profile(np.asarray(bl, float), theta)
	if normalize: br = br/br[0] if br[0] != 0 else br
	return br


beam_transform_to_profile = tform_to_profile


# ---------------------------------------------------------------------------
# dtypes, strings and sexagesimal (pixell_tpu/utils.py:2409-2469): host, but
# ang2chord / chord2ang, which take tensors too
# ---------------------------------------------------------------------------
def fix_dtype_mpi4py(dtype):
	"""dtype in native byte order."""
	return native_dtype(dtype)


def native_dtype(dtype):
	"""dtype in native byte order."""
	dtype = np.dtype(dtype)
	return dtype.newbyteorder("=") if dtype.byteorder not in "=|" else dtype


def decode_array_if_necessary(arr):
	"""A bytes array decoded to str; anything else as it is."""
	arr = np.asarray(arr)
	if arr.dtype.kind == "S":
		return np.char.decode(arr)
	return arr


def encode_array_if_necessary(arr):
	"""A str array encoded to bytes; anything else as it is."""
	arr = np.asarray(arr)
	if arr.dtype.kind == "U":
		return np.char.encode(arr)
	return arr


def chararray_slice(a, sel):
	"""Each string of a sliced by sel."""
	return np.array([s[sel] for s in np.asarray(a).tolist()])


def to_sexa(x):
	"""(sign, degrees, minutes, seconds) of x in decimal degrees."""
	sign = int(np.sign(x)) or 1
	x = abs(x)
	deg = int(x)
	rem = (x - deg)*60
	min_ = int(rem)
	sec = (rem - min_)*60
	return sign, deg, min_, sec


def from_sexa(sign, deg, min, sec):
	"""The decimal degrees of sign, degrees, minutes, seconds."""
	return sign*(deg + min/60 + sec/3600)


def format_sexa(x, fmt="%(deg)+03d:%(min)02d:%(sec)06.2f"):
	"""x in decimal degrees written by fmt from its deg, min and sec. The
	sign rides on deg, so -0.5 degrees is written +00:30:00.00, as in the
	reference (ROADMAP Queue 3)."""
	sign, deg, min_, sec = to_sexa(x)
	return fmt % {"deg": sign*deg, "min": min_, "sec": sec}


def jname(ra, dec, fmt="J%(ra_H)02d%(ra_M)02d%(ra_S)02d%(dec_d)+02d%(dec_m)02d%(dec_s)02d", tag=None, sep=" "):
	"""Object names Jhhmmss+ddmmss of positions in radians (degrees if any
	is larger than a circle), behind tag and sep if a tag is given. The
	sign rides on the degrees, so a declination in (-1, 0) degrees is
	written "+0", as in the reference (ROADMAP Queue 3)."""
	ra = np.degrees(ra) if np.max(np.abs(ra)) <= 2*np.pi else ra
	dec = np.degrees(dec) if np.max(np.abs(dec)) <= np.pi/2 + 0.01 else dec
	def one(r, d):
		r = r % 360
		sh, H, M, S = to_sexa(r/15)
		sd, dd, dm, ds = to_sexa(d)
		name = fmt % {"ra_H": H, "ra_M": M, "ra_S": int(S), "dec_d": sd*dd, "dec_m": dm, "dec_s": int(ds)}
		return tag + sep + name if tag else name
	if np.ndim(ra) == 0: return one(ra, dec)
	return np.array([one(r, d) for r, d in zip(np.atleast_1d(ra), np.atleast_1d(dec))])


def ang2chord(ang):
	"""The chord between two points of a unit circle ang radians apart."""
	if isinstance(ang, torch.Tensor): return 2*torch.sin(ang/2)
	return 2*np.sin(np.asarray(ang)/2)


def chord2ang(chord):
	"""The inverse of ang2chord."""
	if isinstance(chord, torch.Tensor): return 2*torch.arcsin(chord/2)
	return 2*np.arcsin(np.asarray(chord)/2)


# ---------------------------------------------------------------------------
# Files, environment and iterators (pixell_tpu/utils.py:2471-2606), host
# ---------------------------------------------------------------------------
def ascomplex(arr):
	"""arr as complex, at least complex64."""
	arr = np.asarray(arr)
	return arr.astype(np.result_type(arr.dtype, np.complex64))


def astuple(num_or_list):
	"""num_or_list as a tuple, (num,) for a number."""
	try: return tuple(num_or_list)
	except TypeError: return (num_or_list,)


def default_M(x):
	"""The identity preconditioner: a copy of x."""
	return np.asarray(x).copy()


def default_dot(a, b):
	"""The real part of the dot product sum(conj(a) b), as a float."""
	a = np.asarray(a); b = np.asarray(b)
	if np.iscomplexobj(a): return float((a.reshape(-1).conj() @ b.reshape(-1)).real)
	return float(a.reshape(-1) @ b.reshape(-1))


def without_inds(a, inds):
	"""a as a tuple without the entries at inds."""
	if inds is None: return tuple(a)
	inds = set(np.atleast_1d(inds).tolist())
	return tuple(v for i, v in enumerate(a) if i not in inds)


def only_inds(a, inds):
	"""a's entries at inds, as a tuple."""
	return tuple(a[i] for i in np.atleast_1d(inds))


def can_import(name):
	"""Whether the module name imports."""
	try:
		__import__(name)
		return True
	except ImportError:
		return False


def glob(desc, sort=True):
	"""The files the pattern desc matches; a name with no wildcard is given
	back even if no file has it."""
	import glob as globlib
	res = globlib.glob(desc)
	if not res and not any(ch in desc for ch in "*?["):
		res = [desc]
	return sorted(res) if sort else res


def globlist(fnames):
	"""glob of each of fnames, concatenated."""
	res = []
	for fname in np.atleast_1d(fnames):
		res.extend(glob(fname))
	return res


def cache_get(cache, key, op):
	"""cache[key], made by op() on a miss; op() itself without a cache."""
	if cache is None: return op()
	if key not in cache: cache[key] = op()
	return cache[key]


def replace(istr, ipat, repl):
	"""istr.replace(ipat, repl), raising ValueError where ipat is not in istr."""
	if ipat not in istr: raise ValueError("Pattern '%s' not found in '%s'" % (ipat, istr))
	return istr.replace(ipat, repl)


def regreplace(istr, ipat, repl, count=0, flags=0):
	"""re.sub, raising ValueError where the pattern does not match."""
	res, n = re.subn(ipat, repl, istr, count=count, flags=flags)
	if n == 0: raise ValueError("Pattern '%s' not found in '%s'" % (ipat, istr))
	return res


def primes(n):
	"""The prime factors of n, with repeats, in increasing order."""
	res = []
	d = 2
	while d*d <= n:
		while n % d == 0:
			res.append(d)
			n //= d
		d += 1
	if n > 1: res.append(n)
	return res


def res2nside(res):
	"""The HEALPix nside of about the resolution res (radians)."""
	return int(np.round((4*np.pi/12)**0.5/res))


def nside2res(nside):
	"""The resolution (radians) of HEALPix nside."""
	return (4*np.pi/12)**0.5/nside


def split_esc(string, delim, esc="\\"):
	"""The pieces of string between delims not escaped by esc (a generator)."""
	cur = ""
	i = 0
	while i < len(string):
		ch = string[i]
		if ch == esc and i + 1 < len(string):
			cur += string[i+1]
			i += 2
			continue
		if ch == delim:
			yield cur
			cur = ""
		else:
			cur += ch
		i += 1
	yield cur


def getenv(name, default=None):
	"""The environment variable name, or default."""
	return os.environ.get(name, default)


def setenv(name, value, keep=False):
	"""Set (or with None unset) the environment variable name; with keep,
	leave one that is set."""
	if keep and name in os.environ: return
	if value is None:
		os.environ.pop(name, None)
	else:
		os.environ[name] = str(value)


def getaddr(a):
	"""The address of an array's data."""
	return np.asarray(a).__array_interface__["data"][0]


def iscontig(a, naxes=None):
	"""Whether a is C-contiguous, or over its last naxes axes only."""
	a = np.asarray(a)
	if naxes is None: return a.flags["C_CONTIGUOUS"]
	expect = a.itemsize
	for i in range(a.ndim-1, a.ndim-1-naxes, -1):
		if a.shape[i] > 1 and a.strides[i] != expect: return False
		expect *= a.shape[i]
	return True


def zip2(*args):
	"""zip that advances every iterator each round, stopping when any ends."""
	iters = [iter(a) for a in args]
	while True:
		row = []
		stopped = False
		for it in iters:
			try: row.append(next(it))
			except StopIteration: stopped = True
		if stopped: return
		yield tuple(row)


def call_help(fun, *args, **kwargs):
	"""fun(*args, **kwargs). The reference's docstring says that None
	arguments are dropped; none is, there or here (ROADMAP Queue 3)."""
	return fun(*args, **kwargs)


def arg_help(arg):
	"""arg itself."""
	return arg


# ---------------------------------------------------------------------------
# Dice, Airy beams and disks (pixell_tpu/utils.py:2608-2680), host
# ---------------------------------------------------------------------------
def dicedist(N, D):
	"""The distribution of the sum of N D-sided dice (of the sums N .. N D)."""
	dist = np.full(D, 1.0/D)
	return distpow(dist, N)


def distpow(dist, N):
	"""The distribution of the sum of N draws from dist (repeated squaring)."""
	dist = np.asarray(dist, float)
	res = np.array([1.0])
	work = dist
	n = N
	while n:
		if n & 1: res = np.convolve(res, work)
		work = np.convolve(work, work)
		n >>= 1
	return res


def airy(x):
	"""The Airy beam (2 J1(pi x)/(pi x))^2, 1 at x = 0."""
	from scipy import special
	x = np.asarray(x, float)
	with np.errstate(divide="ignore", invalid="ignore"):
		res = (2*special.j1(np.pi*x)/(np.pi*x))**2
	return np.where(x == 0, 1.0, res)


def lairy(x):
	"""The Airy beam's harmonic transform: the autocorrelation of a uniform
	disk, at x in units of its cutoff."""
	x = np.clip(np.asarray(x, float), 0, 1)
	return 2/np.pi*(np.arccos(x) - x*np.sqrt(1 - x**2))


def airy_lmax(D, lam):
	"""The multipole cutoff of a dish of diameter D at wavelength lam."""
	return 2*np.pi*D/lam


def airy_res(D, lam):
	"""The Airy beam's FWHM, 1.22 lam/D."""
	return 1.2196699*lam/D


def airy_area(D, lam):
	"""The Airy beam's solid angle in steradians."""
	return (2*lam/D)**2/np.pi


def disk_overlap(d, R):
	"""The area two flat disks of radius R, d apart, share."""
	x = np.clip(np.asarray(d, float)/(2*R), 0, 1)
	return (np.arccos(x) - x*(1 - x**2)**0.5)*(2*R**2)


def disk_overlap_curved(d, R, tol_flat=1e-4, tol_tiny=1e-10):
	"""The solid angle two spherical caps of radius R, d apart, share (the
	flat formula below R = tol_flat). A scalar d gives a float, which the
	reference meant and does not do (it gives shape (1,); ROADMAP Queue 3)."""
	d = np.asarray(d, float)
	d = np.clip(d, tol_tiny, 2*R)
	if R < tol_flat:
		return disk_overlap(d, R)
	return _disk_overlap_curved_num(d, R)


def _disk_overlap_curved_num(d, R, n=2048):
	"""The caps' shared solid angle by the trapezoid rule over n colatitudes
	of the first cap."""
	d = np.asarray(d, float)
	scalar = d.ndim == 0
	d = np.atleast_1d(d)
	t = np.linspace(0, R, n)
	res = np.empty(d.shape)
	trapezoid = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
	for i, di in enumerate(d.reshape(-1)):
		ct, cd2, cR = np.cos(t), np.cos(di), np.cos(R)
		st, sd = np.sin(t), np.sin(di)
		arg = (cR - ct*cd2)/np.maximum(st*sd, 1e-300)
		phi = np.where(arg >= 1, 0, np.where(arg <= -1, np.pi, np.arccos(np.clip(arg, -1, 1))))
		res.reshape(-1)[i] = 2*trapezoid(phi*st, t)
	return float(res[0]) if scalar else res


# ---------------------------------------------------------------------------
# Formatting, find, broadcasting and polygons (pixell_tpu/utils.py:2682-2855):
# point_in_polygon and poly_edge_dist take tensors too
# ---------------------------------------------------------------------------
def freq2ind(freq, dur):
	"""The Fourier index of freq over a duration dur."""
	return np.asarray(freq)*dur


def ind2freq(ind, dur):
	"""The frequency of Fourier index ind over a duration dur."""
	return np.asarray(ind)/dur


def firstin(ref, alts):
	"""The first of alts that is in ref, or None."""
	for a_ in alts:
		if a_ in ref: return a_
	return None


def getrec(struct_arr, potential_colnames):
	"""The first of the columns potential_colnames that struct_arr has."""
	for name in potential_colnames:
		if name in struct_arr.dtype.names:
			return struct_arr[name]
	raise KeyError("None of %s found" % str(potential_colnames))


def ndigit(num):
	"""The number of decimal digits of non-negative integers."""
	num = np.asarray(num)
	return np.maximum(np.floor(np.log10(np.maximum(num, 1))).astype(int) + 1, 1)


def afmt(arr, fmt=None, ffmt=None, ifmt=None, nmax=None, nedge=None):
	"""np.array2string with a format for every value (fmt), for floats
	(ffmt) or integers (ifmt), nmax values before summarizing, nedge at
	each edge then."""
	arr = np.asarray(arr)
	formatter = {}
	if fmt is not None: formatter["all"] = lambda x: fmt % x
	if ffmt is not None: formatter["float_kind"] = lambda x: ffmt % x
	if ifmt is not None: formatter["int_kind"] = lambda x: ifmt % x
	kw = {}
	if nmax is not None: kw["threshold"] = nmax
	if nedge is not None: kw["edgeitems"] = nedge
	return np.array2string(arr, formatter=formatter or None, **kw)


def aprint(arr, **kwargs):
	"""Print afmt(arr)."""
	print(afmt(arr, **kwargs))


def contains_any(a, bs):
	"""Whether any of bs is in a."""
	return any(b in a for b in bs)


def format_to_glob(format):
	"""A glob pattern that matches what the printf format writes."""
	return re.sub(r"%[^a-zA-Z%]*[a-zA-Z]", "*", format).replace("%%", "%")


def format_to_regex(format):
	"""A regular expression that matches what the printf format writes."""
	res = ""
	i = 0
	spec = re.compile(r"%([^a-zA-Z%]*)([a-zA-Z%])")
	while i < len(format):
		m = spec.match(format, i)
		if m:
			t = m.group(2)
			if t == "%": res += "%"
			elif t in "diu": res += r"[+-]?\d+"
			elif t in "feEgG": res += r"[+-]?[\d.eE+-]+"
			else: res += r".*?"
			i = m.end()
		else:
			res += re.escape(format[i])
			i += 1
	return res


def find(array, vals, default=None, sorted=False):
	"""The index in array of each of vals; ValueError for one missing, or
	default there if given."""
	vals = np.asarray(vals)
	if vals.size == 0: return np.zeros(0, int)
	array = np.asarray(array)
	if sorted:
		res = np.minimum(np.searchsorted(array, vals), len(array)-1)
	else:
		order = np.argsort(array)
		cands = np.minimum(np.searchsorted(array, vals, sorter=order), len(array)-1)
		res = order[cands]
	bad = array[res] != vals
	if np.any(bad):
		if default is None: raise ValueError("Value not found in array")
		res = np.where(bad, default, res)
	return res


def rm(fname):
	"""Remove the file fname if it exists."""
	try: os.remove(fname)
	except FileNotFoundError: pass


def broadcast_shape(*shapes, at=0):
	"""The shape shapes broadcast to, a shorter one padded with axes of
	length 1 at position at (the front by default)."""
	ndim = max(len(s) for s in shapes)
	oshape = [1]*ndim
	for shape in shapes:
		my_at = at if at >= 0 else len(shape) + 1 + at
		padded = tuple(shape[:my_at]) + (1,)*(ndim - len(shape)) + tuple(shape[my_at:])
		for i in range(ndim):
			if oshape[i] != padded[i] and padded[i] != 1:
				if oshape[i] == 1: oshape[i] = padded[i]
				else: raise ValueError("operands could not be broadcast together "
					"with shapes " + " ".join(str(s) for s in shapes))
	return tuple(oshape)


def broadcast_arrays(*arrays, npre=0, npost=0, at=0):
	"""np.broadcast_arrays that passes None through, leaves the first npre
	and last npost axes of each array out of it and pads at position at."""
	npre = np.broadcast_to(npre, len(arrays))
	npost = np.broadcast_to(npost, len(arrays))
	arrays = list(arrays)
	wshapes = []
	for i, a_ in enumerate(arrays):
		if a_ is None: continue
		arrays[i] = np.asanyarray(a_)
		wshapes.append(arrays[i].shape[npre[i]:arrays[i].ndim - npost[i]])
	oshape = broadcast_shape(*wshapes, at=at) if wshapes else ()
	res = []
	for i, a_ in enumerate(arrays):
		if a_ is None:
			res.append(None)
			continue
		pre = a_.shape[:npre[i]]
		post = a_.shape[a_.ndim - npost[i]:] if npost[i] else ()
		mid = a_.shape[npre[i]:a_.ndim - npost[i]]
		my_at = at if at >= 0 else len(mid) + 1 + at
		padded = mid[:my_at] + (1,)*(len(oshape) - len(mid)) + mid[my_at:]
		res.append(np.broadcast_to(a_.reshape(pre + padded + post), pre + oshape + post))
	return res


def point_in_polygon(points, polys):
	"""Whether each of points [..., 2] lies inside the polygons [..., nv, 2]
	(even-odd rule, a horizontal ray per point); a tensor's on its device."""
	if isinstance(points, torch.Tensor):
		points = points if points.is_floating_point() else points.to(torch.float64)
		polys = torch.as_tensor(polys, device=points.device)
		polys = polys if polys.is_floating_point() else polys.to(torch.float64)
		verts = polys - points[..., None, :]
		ncross = torch.zeros(verts.shape[:-2], dtype=torch.int32, device=points.device)
	else:
		points = np.asarray(points) + 0.0
		polys = np.asarray(polys) + 0.0
		verts = polys - points[..., None, :]
		ncross = np.zeros(np.broadcast_shapes(verts.shape[:-2], ()), np.int32)
	for i in range(verts.shape[-2]):
		x1 = verts[..., i-1, 0]; y1 = verts[..., i-1, 1]
		x2 = verts[..., i, 0];   y2 = verts[..., i, 1]
		with nowarn():
			xc = x1 - y1*(x2 - x1)/(y2 - y1)
		ncross = ncross + ((y1*y2 < 0) & (xc > 0))
	return ncross % 2 == 1


def _ang2rect_last(angs):
	"""Unit vectors [..., 3] of angles [..., {phi, theta}] (theta the
	latitude), as ang2rect(angs, axis=-1), for a tensor on its device."""
	phi, theta = angs[..., 0], angs[..., 1]
	ct = torch.cos(theta)
	return torch.stack([ct*torch.cos(phi), ct*torch.sin(phi), torch.sin(theta)], -1)


def poly_edge_dist(points, polygons):
	"""The angular distance of points [..., {ra, dec}] from the nearest edge
	of the spherical polygons [..., nv, {ra, dec}] (radians); a tensor's
	on its device. The distance to a vertex is atan2(|p x v|, p . v), exact
	near the vertex, where the reference's arccos(p . v) loses half the
	digits (1.8e-4 relative 1e-6 rad from a vertex; pixell_tpu/utils.py:2852,
	ROADMAP Queue 3)."""
	if isinstance(points, torch.Tensor):
		t = torch
		polygons = torch.as_tensor(polygons, device=points.device)
		p, verts = _ang2rect_last(points), _ang2rect_last(polygons)
		cross = lambda u, v: torch.linalg.cross(*torch.broadcast_tensors(u, v), dim=-1)
		norm = lambda u: torch.linalg.vector_norm(u, dim=-1)
		floor_ = lambda u: torch.clamp(u, min=1e-300)
		clip = lambda u: torch.clamp(u, -1, 1)
	else:
		t = np
		points = np.asarray(points); polygons = np.asarray(polygons)
		p, verts = ang2rect(points, axis=-1), ang2rect(polygons, axis=-1)
		cross, norm = np.cross, lambda u: np.linalg.norm(u, axis=-1)
		floor_, clip = lambda u: np.maximum(u, 1e-300), lambda u: np.clip(u, -1, 1)
	nvert = polygons.shape[-2]
	dists = []
	for i in range(nvert):
		v1 = verts[..., i, :]
		v2 = verts[..., (i+1) % nvert, :]
		vz = cross(v1, v2)
		vz = vz/floor_(norm(vz)[..., None])
		vy = cross(vz, v1)
		vy = vy/floor_(norm(vy)[..., None])
		# the point's angle along the edge's great circle, and the edge's extent
		pang = t.arctan2((p*vy).sum(-1), (p*v1).sum(-1))
		eang = t.arctan2((v2*vy).sum(-1), (v2*v1).sum(-1))
		inside = (pang >= 0) & (pang <= eang)
		# the distance to the great circle, or to the nearer end
		dcirc = t.abs(t.arcsin(clip((p*vz).sum(-1))))
		d1 = t.arctan2(norm(cross(p, v1)), (p*v1).sum(-1))
		d2 = t.arctan2(norm(cross(p, v2)), (p*v2).sum(-1))
		dists.append(t.where(inside, dcirc, t.minimum(d1, d2)))
	return torch.stack(dists).amin(0) if t is torch else np.min(dists, 0)


# ---------------------------------------------------------------------------
# Communicator helpers (pixell_tpu/utils.py:2869-2921), host numpy over any
# communicator with mpi4py's calls (parallel.dist.TorchCommunicator)
# ---------------------------------------------------------------------------
def reduce(a, comm, root=0, op=None):
	"""The reduction (op, the sum by default) of every rank's a, on root
	(None on the other ranks); a copy of a with no communicator or one
	rank. The reference calls comm.Reduce, which neither package's
	communicator had, and drops op (ROADMAP Queue 3)."""
	if comm is None or getattr(comm, "size", 1) == 1: return np.asarray(a).copy()
	res = np.zeros_like(a) if comm.rank == root else None
	comm.Reduce(np.ascontiguousarray(a), res, root=root, **({} if op is None else {"op": op}))
	return res


def _box_pieces(ib, ob, wrap):
	"""(source, target) slices of every piece of the global array that the
	slice boxes ib and ob [ndim, {start, stop, 1}] share: the source in an
	array over ib, the target in one over ob; ib is also taken shifted by
	a period along each axis with wrap[d] > 0."""
	shifts = [[0] if not w else [-w, 0, w] for w in wrap]
	for shift in itertools.product(*shifts):
		sb = np.array(ib)
		sb[:, :2] += np.array(shift)[:, None]
		isec = sbox_intersect(sb, ob)
		if isec is not None:
			yield sbox2slice(sbox_div(isec, sb)), sbox2slice(sbox_div(isec, ob))


def redistribute(iarrs, iboxes, oboxes, comm, wrap=0):
	"""The slices oboxes of a global array, each rank holding its slices
	iboxes of it as iarrs: boxes are slice boxes [ndim, {start, stop}] (or
	with unit steps) over the arrays' last ndim axes, and an axis with
	wrap > 0 (one value or one an axis) is periodic, so that an obox may
	reach past its end. Every rank sends each other rank the pieces of its
	iarrs that rank's oboxes cover (numpy, over comm's send / recv). The
	reference raises on any box (sbox_intersect of [1, ndim, 3] stacks,
	pixell_tpu/utils.py:2894; ROADMAP Queue 3)."""
	iarrs = [np.asanyarray(a_) for a_ in iarrs]
	iboxes = [sbox_fix(b) for b in iboxes]
	oboxes = [sbox_fix(b) for b in oboxes]
	ndim = len((oboxes or iboxes or [[]])[0])
	wrap = np.zeros(ndim, int) + wrap
	preshape = iarrs[0].shape[:iarrs[0].ndim - ndim] if iarrs else ()
	dtype = iarrs[0].dtype if iarrs else np.float64
	oarrs = [np.zeros(preshape + tuple(sbox_size(b)), dtype) for b in oboxes]
	size = 1 if comm is None else getattr(comm, "size", 1)
	rank = 0 if size == 1 else comm.rank
	all_oboxes = [oboxes] if size == 1 else [comm.bcast(oboxes if rank == r else None, root=r)
		for r in range(size)]
	def pieces_for(r):
		"""(obox index, target slice, data) of this rank's pieces of rank r's oboxes."""
		return [(oi, osl, np.ascontiguousarray(ia[isl])) for oi, ob in enumerate(all_oboxes[r])
			for ia, ib in zip(iarrs, iboxes) for isl, osl in _box_pieces(ib, ob, wrap)]
	def put(pieces):
		for oi, osl, data in pieces: oarrs[oi][osl] = data
	put(pieces_for(rank))
	# every (source, target) pair in one order on every rank: no pair waits on a later one
	for src in range(size):
		for dst in range(size):
			if src == dst: continue
			if rank == src: comm.send(pieces_for(dst), dest=dst)
			elif rank == dst: put(comm.recv(source=src))
	return oarrs
