"""Analytic WCS for CAR sky maps (counterpart of pixell_tpu/wcsutils.py).

The reference module is numpy-only, so this is nearly verbatim: the
_WCSParams/WCS classes (pixell_tpu/wcsutils.py:32-145), CAR and plain
pix2world/world2pix (:282-316), and the introspection helpers get_proj,
is_plain, is_cyl and is_separable (:322-377). Pixel<->world maths is host
work on numpy arrays. Only CAR with crval_dec = 0 (and plain) is
implemented; other projections raise NotImplementedError.
"""
from __future__ import annotations
import numpy as np


class _WCSParams:
	"""The low-level FITS fields, mimicking astropy's wcs.wcs attribute
	(pixell_tpu.wcsutils._WCSParams)."""
	__slots__ = ["ctype", "crval", "crpix", "cdelt", "lonpole", "latpole", "_pv"]
	def __init__(self):
		self.ctype = ["", ""]
		self.crval = np.zeros(2)
		self.crpix = np.zeros(2)
		self.cdelt = np.ones(2)
		self.lonpole = None
		self.latpole = None
		self._pv = {}


class WCS:
	"""Minimal analytic WCS (pixell_tpu.wcsutils.WCS): .wcs.{ctype, crval,
	crpix, cdelt} in FITS conventions (degrees, 1-based crpix, x = lon)."""
	def __init__(self, naxis=2):
		if naxis != 2: raise ValueError("Only 2D WCS supported")
		self.naxis = naxis
		self.wcs = _WCSParams()
	@classmethod
	def from_fields(cls, ctype, crval, crpix, cdelt):
		"""Build a WCS from the four FITS field pairs, e.g. the numpy fields
		of a pixell_tpu WCS."""
		res = cls(2)
		res.wcs.ctype = [str(c) for c in ctype]
		res.wcs.crval = np.array(crval, float)
		res.wcs.crpix = np.array(crpix, float)
		res.wcs.cdelt = np.array(cdelt, float)
		return res
	def deepcopy(self):
		res = WCS.from_fields(self.wcs.ctype, self.wcs.crval, self.wcs.crpix,
			self.wcs.cdelt)
		res.wcs.lonpole = self.wcs.lonpole
		res.wcs.latpole = self.wcs.latpole
		res.wcs._pv = dict(self.wcs._pv)
		return res
	def _key(self):
		return (tuple(self.wcs.ctype), tuple(np.round(self.wcs.crval, 12)),
			tuple(np.round(self.wcs.crpix, 12)), tuple(np.round(self.wcs.cdelt, 16)),
			self.wcs.lonpole, self.wcs.latpole, tuple(sorted(self.wcs._pv.items())))
	def __hash__(self): return hash(self._key())
	def __eq__(self, other):
		return isinstance(other, WCS) and self._key() == other._key()
	def __repr__(self): return describe(self)
	__str__ = __repr__


def _check_supported(wcs):
	system = get_proj(wcs)
	if system in ["", "plain"]: return system
	if system != "car" or wcs.wcs.crval[1] != 0:
		raise NotImplementedError("only CAR with crval_dec = 0 and plain "
			"projections are ported, got %s" % describe(wcs))
	return system


def pix2world(wcs, x, y, origin=0):
	"""Pixel (x, y) -> world (lon, lat) in degrees (pixell_tpu.wcsutils.pix2world)."""
	_check_supported(wcs)
	x = np.asarray(x); y = np.asarray(y)
	off = 1 - origin  # FITS crpix is 1-based
	u = (x + off - wcs.wcs.crpix[0])*wcs.wcs.cdelt[0]
	v = (y + off - wcs.wcs.crpix[1])*wcs.wcs.cdelt[1]
	# plain: affine; CAR with crval_dec = 0: the native->celestial rotation
	# is a longitude shift
	return u + wcs.wcs.crval[0], v + wcs.wcs.crval[1]


def world2pix(wcs, lon, lat, origin=0):
	"""World (lon, lat) in degrees -> pixel (x, y) (pixell_tpu.wcsutils.world2pix)."""
	_check_supported(wcs)
	lon = np.asarray(lon); lat = np.asarray(lat)
	off = 1 - origin
	u = lon - wcs.wcs.crval[0]; v = lat - wcs.wcs.crval[1]
	x = u/wcs.wcs.cdelt[0] + wcs.wcs.crpix[0] - off
	y = v/wcs.wcs.cdelt[1] + wcs.wcs.crpix[1] - off
	return x, y


def get_proj(wcs):
	if isinstance(wcs, str): return wcs
	toks = wcs.wcs.ctype[0].split("-")
	return toks[-1].lower() if len(toks) >= 2 else ""

def describe(wcs):
	sys = get_proj(wcs) or "plain"
	fields = "cdelt:[%.4g,%.4g],crval:[%.4g,%.4g],crpix:[%.2f,%.2f]" % (
		tuple(wcs.wcs.cdelt) + tuple(wcs.wcs.crval) + tuple(wcs.wcs.crpix))
	return "%s:{%s}" % (sys, fields)

def is_plain(wcs):
	return get_proj(wcs) in ["", "plain"]

def is_cyl(wcs):
	return get_proj(wcs) in ["cyp", "cea", "car", "mer"]

def is_separable(wcs):
	return is_cyl(wcs) and wcs.wcs.crval[1] == 0
