"""FFT size and spectrum-resampling helpers (counterpart of pixell_tpu/fft.py).

Only fft_len (pixell_tpu/fft.py:199) and resample (:244) are ported; the
transforms themselves are torch.fft.
"""
from __future__ import annotations
import numpy as np
import torch


def fft_len(n, direction="below", factors=None):
	"""Closest fast FFT size to n (products of 2, 3, 5, 7)."""
	if factors is None: factors = [2, 3, 5, 7]
	def ok(m):
		for f in factors:
			while m % f == 0: m //= f
		return m == 1
	m = int(n)
	step = -1 if direction == "below" else 1
	while m > 1 and not ok(m): m += step
	return max(m, 1)


def resample(fa, n, axes=(-1,)):
	"""Fourier-space resample: truncate or zero-pad the (unshifted) spectrum
	fa to n samples along each of axes. An even-length Nyquist bin is split
	symmetrically when padding and absorbs both halves when truncating."""
	naxes = [int(ax) % fa.ndim for ax in np.atleast_1d(axes)]
	ns = (np.zeros(len(naxes), int) + np.asarray(n)).tolist()
	for ax, n_new in zip(naxes, ns):
		n_old = fa.shape[ax]
		fa = fa.movedim(ax, -1)
		nh_old, nh_new = n_old//2, n_new//2
		if n_new < n_old:
			keep_lo = (n_new+1)//2
			fa2 = torch.cat([fa[..., :keep_lo], fa[..., n_old-nh_new:]], -1)
			if n_new % 2 == 0:
				fa2[..., keep_lo] += fa[..., nh_new]
			fa = fa2
		elif n_new > n_old:
			keep_lo = (n_old+1)//2
			zeros = fa.new_zeros(fa.shape[:-1] + (n_new - n_old - (n_old % 2 == 0),))
			if n_old % 2 == 0:
				nyq = fa[..., nh_old:nh_old+1]/2
				fa = torch.cat([fa[..., :nh_old], nyq, zeros, nyq, fa[..., nh_old+1:]], -1)
			else:
				fa = torch.cat([fa[..., :keep_lo], zeros, fa[..., keep_lo:]], -1)
		fa = fa.movedim(-1, ax)
	return fa
