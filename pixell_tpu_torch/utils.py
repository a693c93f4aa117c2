"""Constants and small host-side helpers (counterpart of pixell_tpu/utils.py).

Only what the curved-sky path needs: the angle constants, nint,
rewind/unwind for the pixel<->sky conversions, eigpow for rand_alm and the
Minres solver of curvedsky.minres_inverse. All of it is numpy: geometry,
random draws and that solver's vectors are host work.
"""
from __future__ import annotations
import numpy as np

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
