"""Constants and small host-side helpers (counterpart of pixell_tpu/utils.py).

Only what the spin-0 curved-sky path needs: the angle constants, nint,
rewind/unwind for the pixel<->sky conversions, and eigpow for rand_alm.
All of it is numpy: geometry and random draws are host work.
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
