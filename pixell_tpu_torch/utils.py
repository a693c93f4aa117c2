"""Constants and small host-side helpers (counterpart of pixell_tpu/utils.py).

Only what the ported modules call: the angle constants, nint,
rewind/unwind for the pixel<->sky conversions, eigpow for rand_alm and
spec2flat, the Minres solver of curvedsky.minres_inverse, and for the flat
sky split_slice / expand_slice (ndmap indexing), nditer, real_dtype /
complex_dtype (numpy or torch dtypes) and ang2rect / rect2ang / angdist
(modrmap, extent's subgrid). Apart from the dtype maps all of it is numpy:
geometry, random draws and that solver's vectors are host work.
"""
from __future__ import annotations
import numpy as np
import torch

degree = np.pi/180
arcmin = degree/60


def nint(a):
	"""Round to nearest integer, returning int dtype (pixell_tpu.utils.nint)."""
	return np.round(a).astype(int)


def rewind(a, ref=0, period=2*np.pi):
	"""Map angles into (ref-period/2, ref+period/2] (pixell_tpu.utils.rewind)."""
	a = np.asarray(a)
	if isinstance(ref, str) and ref == "auto":
		ref = np.sort(a.reshape(-1))[a.size//2]
	return ref + (a - ref + period/2) % period - period/2


def unwind(a, period=2*np.pi, axes=[-1], ref=None, refmode="left"):
	"""Remove period jumps along axes so the result is continuous
	(pixell_tpu.utils.unwind)."""
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
	zeroed for e < 0."""
	A = np.asarray(A)
	ax1, ax2 = axes[0] % A.ndim, axes[1] % A.ndim
	A = np.moveaxis(A, (ax1, ax2), (-2, -1))
	E, V = np.linalg.eigh(A)
	fdt = E.dtype if E.dtype.kind == "f" else np.dtype(np.float64)
	if rlim is None: rlim = np.finfo(fdt).resolution*100
	if alim is None: alim = np.finfo(fdt).tiny*1e4
	is_int = float(e) == int(e)
	mask = np.zeros(E.shape, bool)
	if not is_int: mask = mask | (E < 0)
	if e < 0:
		aE = np.abs(E)
		mask = mask | (aE < np.max(aE, -1, keepdims=True)*rlim) | (aE < alim)
	sgn = np.where(E < 0, (-1.0)**int(e) if is_int else 1.0, 1.0)
	Ez = np.where(mask, 1.0, np.abs(E))
	Ep = np.where(mask, 0.0, sgn*Ez**e)
	res = np.einsum("...ij,...j,...kj->...ik", V, Ep, V)
	return np.moveaxis(res, (-2, -1), (ax1, ax2))


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
