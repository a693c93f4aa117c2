"""Up- and down-sampling of maps (counterpart of pixell_tpu/resample.py).

Every function works on tensors on their device (an ndmap keeps its wcs,
rescaled); host data goes to device="cuda" unless told otherwise. The
Fourier resampling is fft.resample_fft, the spline and bilinear ones
interpol.map_coordinates, the binned ones utils.block_reduce / upgrade.
"""
from __future__ import annotations
import numpy as np
import torch
from . import utils, interpol
from . import fft as enfft


def _data(d, device):
	"""(the tensor of d, the ndmap d or None)."""
	if hasattr(d, "wcs"): return d.data, d
	return (d if isinstance(d, torch.Tensor) else torch.as_tensor(np.asarray(d), device=device)), None


def resample(d, factors=None, method="fft", mode="wrap", corner=False, order=3, *, device="cuda"):
	"""The last two axes of d (an ndmap or an array) resampled by factors
	(a scale, one or per axis; whole numbers all above 8 are the target
	shape instead, as in the reference) by method "fft", "spline" (order
	order) or "bilinear", with the border mode (pixell_tpu.resample.resample)."""
	from . import enmap
	arr, m = _data(d, device)
	oshape = _target_shape(arr.shape, factors)
	if method == "fft":
		res = enfft.resample_fft(arr, oshape, axes=(-2, -1))
	elif method in ["spline", "bilinear", "linear"]:
		fy = arr.shape[-2]/oshape[-2]
		fx = arr.shape[-1]/oshape[-1]
		oy = torch.arange(oshape[-2], dtype=torch.float64, device=arr.device)*fy + (0 if corner else (fy-1)/2)
		ox = torch.arange(oshape[-1], dtype=torch.float64, device=arr.device)*fx + (0 if corner else (fx-1)/2)
		pts = torch.stack(torch.meshgrid(oy, ox, indexing="ij")).reshape(2, -1)
		o = 1 if method in ["bilinear", "linear"] else order
		res = interpol.map_coordinates(arr, pts, order=o, border=mode).reshape(arr.shape[:-2] + tuple(oshape))
	else:
		raise ValueError("Unknown resample method '%s'" % method)
	if m is None: return res
	_, owcs = enmap.scale_geometry(m.shape, m.wcs, np.array(oshape, float)/np.array(m.shape[-2:]))
	return enmap.ndmap(res, owcs)


def _target_shape(ishape, factors):
	"""The output shape of resample: whole factors all above 8 are a shape
	(so [16, 16] gives 16 x 16 pixels while [2, 2] doubles the map), any
	other factors scale ishape's last two axes."""
	factors = np.atleast_1d(np.asarray(factors))
	if factors.size == 1: factors = np.repeat(factors, 2)
	if np.all(factors == factors.astype(int)) and np.all(factors > 8):
		return tuple(int(f) for f in factors)
	return tuple(int(n) for n in utils.nint(np.array(ishape[-2:])*factors))


def resample_bin(d, factors=[0.5], axes=None, *, device="cuda"):
	"""d averaged over bins of 1/factors pixels along axes (the last ones by
	default), partial bins dropped (pixell_tpu.resample.resample_bin)."""
	from . import enmap
	arr, m = _data(d, device)
	factors = np.atleast_1d(factors)
	if axes is None: axes = [-len(factors)+i for i in range(len(factors))]
	res = arr
	for f, ax in zip(factors, axes):
		res = utils.block_reduce(res, int(utils.nint(1/f)), axis=ax, inclusive=False)
	if m is None: return res
	_, owcs = enmap.downgrade_geometry(m.shape, m.wcs, np.array(arr.shape[-2:])//np.array(res.shape[-2:]))
	return enmap.ndmap(res, owcs)


def downsample_bin(d, steps=[2], axes=None, *, device="cuda"):
	"""d averaged over blocks of steps pixels along axes, partial blocks
	dropped (pixell_tpu.resample.downsample_bin)."""
	steps = np.atleast_1d(steps)
	if axes is None: axes = list(range(-len(steps), 0))
	return utils.downgrade(_data(d, device)[0], steps, axes=axes, inclusive=False)


def upsample_bin(d, steps=[2], axes=None, *, device="cuda"):
	"""Each value of d repeated steps times along axes
	(pixell_tpu.resample.upsample_bin)."""
	steps = np.atleast_1d(steps)
	if axes is None: axes = list(range(-len(steps), 0))
	return utils.upgrade(_data(d, device)[0], steps, axes=axes)


def resample_fft_simple(d, n, ngroup=100, *, device="cuda"):
	"""d Fourier-resampled to n samples along its last axis
	(pixell_tpu.resample.resample_fft_simple; ngroup is accepted and ignored)."""
	return enfft.resample_fft(_data(d, device)[0], n, axes=(-1,))


def make_equispaced(d, t, quantile=0.1, order=3, mask_nan=False, *, device="cuda"):
	"""(d resampled to a constant rate, the new times): d [..., n] sampled
	at the irregular times t [n], at the quantile of t's steps, by spline
	interpolation of order with the nearest border
	(pixell_tpu.resample.make_equispaced). The times are host numpy."""
	arr, _ = _data(d, device)
	t = np.asarray(t, float)
	dt = np.quantile(np.diff(t), quantile)
	n = int(np.floor((t[-1] - t[0])/dt)) + 1
	t_out = t[0] + np.arange(n)*dt
	idx = np.interp(t_out, t, np.arange(len(t)))   # fractional indices into the old sampling
	res = interpol.map_coordinates(arr.to(torch.float64), torch.from_numpy(idx[None]).to(arr.device),
		order=order, border="nearest")
	if mask_nan: res = torch.nan_to_num(res, nan=0.0, posinf=0.0, neginf=0.0)
	return res, t_out


def resample_fft(d, n, axes=None, *, device="cuda"):
	"""d Fourier-resampled to lengths n along axes (the last ones by
	default) (pixell_tpu.resample.resample_fft)."""
	n = np.atleast_1d(n)
	if axes is None: axes = list(range(-len(n), 0))
	return enfft.resample_fft(_data(d, device)[0], n, axes=tuple(np.atleast_1d(axes)))
