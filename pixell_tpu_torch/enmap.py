"""ndmap: a sky map as a torch tensor plus its WCS (counterpart of
pixell_tpu/enmap.py).

Ports the core the curved-sky SHT path needs: the ndmap container
(pixell_tpu/enmap.py:33), zeros/empty (on device="cuda" unless told
otherwise; with no CUDA device they raise), samewcs
(:319), pix2sky (:418), posaxes (:452), slice_geometry (:791) and
fullsky_geometry (:1029).
Geometry maths is host numpy; only the pixel data lives in a tensor.
"""
from __future__ import annotations
import numpy as np
import torch
from . import utils, wcsutils


def get_unit(wcs):
	"""Maps are in radians unless plain (pixell_tpu.enmap.get_unit)."""
	return 1.0 if wcsutils.is_plain(wcs) else utils.degree


class ndmap:
	"""A map: a torch tensor ``data`` and its ``wcs``. Arithmetic is done on
	``data``; the geometry methods delegate to the module functions."""
	__slots__ = ("data", "wcs")

	def __init__(self, arr, wcs):
		if isinstance(arr, ndmap): arr = arr.data
		if not isinstance(arr, torch.Tensor): arr = torch.as_tensor(arr)
		self.data = arr
		self.wcs = wcs

	@property
	def shape(self): return tuple(self.data.shape)
	@property
	def ndim(self): return self.data.ndim
	@property
	def dtype(self): return self.data.dtype
	@property
	def device(self): return self.data.device
	def __repr__(self):
		return "ndmap(%r,%s)" % (self.data, wcsutils.describe(self.wcs))
	def __array__(self, dtype=None, copy=None):
		return np.asarray(self.data.detach().cpu(), dtype=dtype)
	def posaxes(self, safe=True, corner=False):
		return posaxes(self.shape, self.wcs, safe=safe, corner=corner)
	def pix2sky(self, pix, safe=True, corner=False):
		return pix2sky(self.shape, self.wcs, pix, safe, corner)


def samewcs(arr, *args):
	"""arr wrapped in an ndmap with the wcs of the first ndmap among
	(arr,) + args, or arr itself (pixell_tpu.enmap.samewcs)."""
	for a in (arr,) + args:
		if isinstance(a, ndmap):
			return ndmap(arr.data if isinstance(arr, ndmap) else arr, a.wcs)
	return arr


def zeros(shape, wcs=None, dtype=torch.float64, device="cuda"):
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	return ndmap(torch.zeros(shape, dtype=dtype, device=device), wcs)

def empty(shape, wcs=None, dtype=torch.float64, device="cuda"):
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	return ndmap(torch.empty(shape, dtype=dtype, device=device), wcs)


def pix2sky(shape, wcs, pix, safe=True, corner=False):
	"""Pixel coordinates [{y,x},...] -> sky coordinates [{dec,ra},...] in
	radians, as numpy (pixell_tpu.enmap.pix2sky)."""
	pix = np.asarray(pix).astype(float)
	if corner: pix = pix - 0.5
	y, x = pix[0], pix[1]
	ra, dec = wcsutils.pix2world(wcs, x, y, 0)
	unit = get_unit(wcs)
	coords = np.stack([dec*unit, ra*unit])
	if safe and not wcsutils.is_plain(wcs) and coords[1].ndim > 0:
		coords = np.concatenate([coords[:1],
			utils.unwind(coords[1:2], refmode="middle")], 0)
	return coords


def posaxes(shape, wcs, safe=True, corner=False):
	"""(dec[ny], ra[nx]) axes of a separable geometry, in radians
	(pixell_tpu.enmap.posaxes)."""
	y = np.arange(shape[-2], dtype=float)
	x = np.arange(shape[-1], dtype=float)
	dec = pix2sky(shape, wcs, np.array([y, y*0]), safe=safe, corner=corner)[0]
	ra = pix2sky(shape, wcs, np.array([x*0, x]), safe=safe, corner=corner)[1]
	return dec, ra


def slice_geometry(shape, wcs, sel, nowrap=False):
	"""The geometry of map[..., sel[0], sel[1]]: sel is a y slice or a tuple
	of (y, x) slices, with steps if wanted (pixell_tpu.enmap.slice_geometry
	:791). With nowrap the slices are taken as they stand, so starts and
	stops may lie outside the map."""
	wcs = wcs.deepcopy()
	pre, shape = shape[:-2], shape[-2:]
	if not isinstance(sel, tuple): sel = (sel,)
	oshape = list(shape)
	for i, s in enumerate(list(sel)[:2]):   # sel is (y, x); the wcs axes are (x, y)
		if s is None: raise ValueError("newaxis not supported in slice_geometry")
		if nowrap:
			step = s.step if s.step is not None else 1
			start = s.start if s.start is not None else (0 if step > 0 else shape[i] - 1)
			stop = s.stop if s.stop is not None else (shape[i] if step > 0 else -1)
		else:
			start, stop, step = s.indices(shape[i])
		oshape[i] = len(range(start, stop, step))
		# the new 0-based pixel p_new = (p_old - start)/step
		wcs.wcs.crpix[1 - i] = (wcs.wcs.crpix[1 - i] - 1 - start)/step + 1
		wcs.wcs.cdelt[1 - i] = wcs.wcs.cdelt[1 - i]*step
	return tuple(pre) + tuple(oshape), wcs


def fullsky_geometry(res=None, shape=None, dims=(), proj="car", variant="fejer1"):
	"""Full-sky CAR geometry with SHT-exact ring placement
	(pixell_tpu.enmap.fullsky_geometry). "cc" puts pixel centres on the
	poles; "fejer1" offsets them by half a pixel."""
	if proj != "car": raise NotImplementedError("only CAR fullsky geometry is ported")
	if   variant.lower() == "cc":     yo = 1
	elif variant.lower() == "fejer1": yo = 0
	else: raise ValueError("Unrecognized CAR variant '%s'" % str(variant))
	if shape is None:
		res = np.zeros(2) + res
		shape = utils.nint(np.array([1*np.pi, 2*np.pi])/res + np.array([yo, 0]))
	else:
		res = np.array([1*np.pi, 2*np.pi])/(np.array(shape[-2:]) - np.array([yo, 0]))
	ny, nx = shape[-2:]
	if abs(res[0]*(ny-yo) - np.pi) > 1e-8 or abs(res[1]*nx - 2*np.pi) > 1e-8:
		raise ValueError("SHT-exact ring placement needs a whole number of pixels "
			"spanning the sky; got res=%s" % str(res))
	wcs = wcsutils.WCS.from_fields(["RA---CAR", "DEC--CAR"],
		[res[1]/2/utils.degree, 0], [nx//2+0.5, (ny+1)/2], [-360./nx, 180./(ny-yo)])
	return tuple(dims) + (int(ny), int(nx)), wcs
