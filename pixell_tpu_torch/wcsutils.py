"""Analytic World Coordinate System (WCS) for sky maps (counterpart of
pixell_tpu/wcsutils.py).

The reference module is numpy only, so this is its port nearly verbatim,
on numpy arrays: the WCS class with its FITS header interop and hashing by
value (curvedsky's caches key on it), the cylindrical projections CAR, CEA
(with its PV2_1 lambda) and MER, the zenithal TAN, SIN, ZEA, ARC, AIR and
STG, crval_dec != 0 through the native pole of Calabretta & Greisen 2002
paper II section 2.4 (pixell_tpu/wcsutils.py:207-280), and the builders,
pixelizations and introspection helpers. Pixel <-> world maths is host
work: the port keeps only maps in tensors.
"""
from __future__ import annotations
import numpy as np
from . import utils

deg2rad = np.pi/180
rad2deg = 180/np.pi

def streq(x, s): return isinstance(x, str) and x == s


class _WCSParams:
	"""Holds the low-level FITS fields, mimicking astropy's wcs.wcs attribute."""
	__slots__ = ["ctype", "crval", "crpix", "cdelt", "lonpole", "latpole", "_pv"]
	def __init__(self):
		self.ctype  = ["", ""]
		self.crval  = np.zeros(2)
		self.crpix  = np.zeros(2)
		self.cdelt  = np.ones(2)
		# None = unset: the FITS defaults depend on the projection and
		# crval (Calabretta & Greisen 2002 II sec 2.4), and an EXPLICIT
		# LONPOLE=180 on a cylindrical header is valid and must not be
		# confused with "defaulted" -- see _eff_lonpole/_eff_latpole.
		self.lonpole = None
		self.latpole = None
		self._pv = {}
	def set_pv(self, pvs):
		self._pv = {(int(i), int(m)): float(v) for i, m, v in pvs}
	def get_pv(self):
		return [(i, m, v) for (i, m), v in sorted(self._pv.items())]
	def compare(self, other, flags=1, tol=1e-14):
		if list(self.ctype) != list(other.ctype): return False
		for a, b in [(self.crval, other.crval), (self.crpix, other.crpix),
				(self.cdelt, other.cdelt)]:
			if np.any(np.abs(np.asarray(a) - np.asarray(b)) > tol*np.maximum(1, np.abs(a))):
				return False
		return self._pv == other._pv
	def bounds_check(self, *args): pass


class WCS:
	"""Minimal analytic WCS. API-compatible with the subset of astropy.wcs.WCS
	that the reference pixell uses: .wcs.{ctype,crval,crpix,cdelt},
	wcs_pix2world, wcs_world2pix, deepcopy, to_header."""
	def __init__(self, naxis=2, header=None):
		if naxis != 2: raise ValueError("Only 2D WCS supported")
		self.naxis = naxis
		self.wcs = _WCSParams()
		if header is not None:
			self._from_header(header)
	# -- construction/copy ---------------------------------------------------
	@classmethod
	def from_fields(cls, ctype, crval, crpix, cdelt, pv=None, lonpole=None, latpole=None):
		"""A WCS from its FITS fields: ctype, crval, crpix and cdelt pairs,
		pv as {(i, m): value} or [(i, m, value), ...], lonpole and latpole
		(None: the FITS defaults)."""
		res = cls(2)
		res.wcs.ctype = [str(c) for c in ctype]
		res.wcs.crval = np.array(crval, float)
		res.wcs.crpix = np.array(crpix, float)
		res.wcs.cdelt = np.array(cdelt, float)
		res.wcs.lonpole = None if lonpole is None else float(lonpole)
		res.wcs.latpole = None if latpole is None else float(latpole)
		if isinstance(pv, dict): pv = [(i, m, v) for (i, m), v in pv.items()]
		if pv is not None: res.wcs.set_pv(pv)
		return res
	@classmethod
	def from_wcs(cls, other):
		"""A copy of any WCS whose .wcs holds the FITS fields (this class's,
		pixell_tpu's or astropy's), pv, lonpole and latpole included."""
		w = other.wcs
		get_pv = getattr(w, "get_pv", None)
		return cls.from_fields(w.ctype, w.crval, w.crpix, w.cdelt,
			pv=list(get_pv()) if get_pv is not None else None,
			lonpole=getattr(w, "lonpole", None), latpole=getattr(w, "latpole", None))
	def deepcopy(self):
		res = WCS(self.naxis)
		res.wcs.ctype = list(self.wcs.ctype)
		res.wcs.crval = np.array(self.wcs.crval, float)
		res.wcs.crpix = np.array(self.wcs.crpix, float)
		res.wcs.cdelt = np.array(self.wcs.cdelt, float)
		res.wcs.lonpole = self.wcs.lonpole
		res.wcs.latpole = self.wcs.latpole
		res.wcs._pv = dict(self.wcs._pv)
		return res
	def copy(self): return self.deepcopy()
	def __copy__(self): return self.deepcopy()
	def __deepcopy__(self, memo): return self.deepcopy()
	def sub(self, n=2): return self.deepcopy()
	# -- header interop ------------------------------------------------------
	def to_header(self):
		hdr = {}
		for i in range(2):
			ct = self.wcs.ctype[i]
			if ct: hdr["CTYPE%d" % (i+1)] = ct
			hdr["CRVAL%d" % (i+1)] = float(self.wcs.crval[i])
			hdr["CRPIX%d" % (i+1)] = float(self.wcs.crpix[i])
			hdr["CDELT%d" % (i+1)] = float(self.wcs.cdelt[i])
		if get_proj(self) not in ["", "plain"]:
			# unset (None) keys are omitted: readers apply the FITS defaults
			if self.wcs.lonpole is not None:
				hdr["LONPOLE"] = float(self.wcs.lonpole)
			if self.wcs.latpole is not None:
				hdr["LATPOLE"] = float(self.wcs.latpole)
		for (i, m), v in self.wcs._pv.items():
			hdr["PV%d_%d" % (i, m)] = v
		return hdr
	def _from_header(self, hdr):
		get = lambda k, d: hdr.get(k, d) if hasattr(hdr, "get") else d
		self.wcs.ctype = [str(get("CTYPE1", "")).strip(), str(get("CTYPE2", "")).strip()]
		self.wcs.crval = np.array([get("CRVAL1", 0.), get("CRVAL2", 0.)], float)
		self.wcs.crpix = np.array([get("CRPIX1", 0.), get("CRPIX2", 0.)], float)
		cd = [get("CDELT1", 1.), get("CDELT2", 1.)]
		self.wcs.cdelt = np.array(cd, float)
		lp = get("LONPOLE", None)
		self.wcs.lonpole = None if lp is None else float(lp)
		lt = get("LATPOLE", None)
		self.wcs.latpole = None if lt is None else float(lt)
		for key in (hdr.keys() if hasattr(hdr, "keys") else []):
			if isinstance(key, str) and key.startswith("PV"):
				try:
					i, m = key[2:].split("_")
					self.wcs._pv[(int(i), int(m))] = float(hdr[key])
				except (ValueError, KeyError): pass
	# -- core transforms (degrees, FITS axis order x=lon) ---------------------
	def wcs_pix2world(self, x, y, origin=0):
		"""Pixel (x,y) -> world (lon,lat) in degrees. origin=0 for 0-based pixels."""
		return pix2world(self, x, y, origin)
	def wcs_world2pix(self, lon, lat, origin=0):
		return world2pix(self, lon, lat, origin)
	# -- value semantics -------------------------------------------------------
	def _key(self):
		lp = self.wcs.lonpole; lt = self.wcs.latpole
		return (tuple(self.wcs.ctype), tuple(np.round(self.wcs.crval, 12)),
			tuple(np.round(self.wcs.crpix, 12)), tuple(np.round(self.wcs.cdelt, 16)),
			None if lp is None else round(lp, 12),
			None if lt is None else round(lt, 12),
			tuple(sorted(self.wcs._pv.items())))
	def __hash__(self): return hash(self._key())
	def __eq__(self, other):
		return isinstance(other, WCS) and self._key() == other._key()
	def __repr__(self): return describe(self)
	__str__ = __repr__


# ---------------------------------------------------------------------------
# Projection math. All functions work in degrees and FITS (lon,lat) order,
# on numpy arrays.
# ---------------------------------------------------------------------------
def _native2proj(system, phi, theta, pv):
	"""Native spherical (phi,theta) [deg] -> intermediate projection plane
	(u,v) [deg]. theta is native latitude."""
	if system == "car":
		return phi, theta
	elif system == "cea":
		lam = pv.get((2, 1), 1.0)
		return phi, np.sin(theta*deg2rad)*rad2deg/lam
	elif system == "mer":
		return phi, np.log(np.tan((45 + theta/2)*deg2rad))*rad2deg
	elif system in ["tan", "sin", "zea", "arc", "air", "stg"]:
		# zenithal: R(theta), azimuth phi; x = R sin(phi), y = -R cos(phi)
		zd = (90 - theta)*deg2rad  # native zenith distance in rad
		if   system == "tan": R = np.tan(zd)*rad2deg
		elif system == "sin": R = np.sin(zd)*rad2deg
		elif system == "zea": R = 2*np.sin(zd/2)*rad2deg
		elif system == "arc": R = zd*rad2deg
		elif system == "stg": R = 2*np.tan(zd/2)*rad2deg
		elif system == "air":
			# Airy projection with theta_b = 90 (simplified limit): R ~ -2 ln(cos(zd/2)) / tan(zd/2)
			hz = zd/2
			small = np.abs(hz) < 1e-8
			hz_safe = np.where(small, 1e-8, hz)
			R = np.where(small, zd, -2*np.log(np.cos(hz_safe))/np.tan(hz_safe))*rad2deg
		p = phi*deg2rad
		return R*np.sin(p), -R*np.cos(p)
	else:
		raise ValueError("Unsupported projection '%s'" % system)

def _proj2native(system, u, v, pv):
	"""Intermediate (u,v) [deg] -> native (phi,theta) [deg]."""
	if system == "car":
		return u, v
	elif system == "cea":
		lam = pv.get((2, 1), 1.0)
		return u, np.arcsin(np.clip(v*deg2rad*lam, -1, 1))*rad2deg
	elif system == "mer":
		return u, (2*np.arctan(np.exp(v*deg2rad))*rad2deg - 90)
	elif system in ["tan", "sin", "zea", "arc", "air", "stg"]:
		R = np.sqrt(u*u + v*v)
		phi = np.arctan2(u, -v)*rad2deg
		Rr = R*deg2rad
		if   system == "tan": zd = np.arctan(Rr)
		elif system == "sin": zd = np.arcsin(np.clip(Rr, -1, 1))
		elif system == "zea": zd = 2*np.arcsin(np.clip(Rr/2, -1, 1))
		elif system == "arc": zd = Rr
		elif system == "stg": zd = 2*np.arctan(Rr/2)
		elif system == "air":
			# invert _native2proj's R(zd) = -2 ln(cos h)/tan h, h = zd/2, by
			# Newton's method (R ~ zd/2 near the centre, monotonic up to zd ~
			# 126 degrees): dR/dzd = 1 + ln(cos h)/sin^2 h, by its series
			# where h is small. (The reference's iteration takes tan h for
			# the 1 and does not converge, pixell_tpu/wcsutils.py:208-216.)
			zd = 2*Rr
			for _ in range(30):
				hz = np.maximum(zd/2, 1e-300)
				small = hz < 1e-4
				hs = np.where(small, 1.0, hz)
				f = np.where(small, hz - hz**3/6, -2*np.log(np.cos(hs))/np.tan(hs))
				df = np.where(small, 0.5 - hz**2/4, 1 + np.log(np.cos(hs))/np.sin(hs)**2)
				zd = zd - (f - Rr)/df
			zd = np.clip(zd, 0, np.pi)
		theta = 90 - zd*rad2deg
		return phi, theta
	else:
		raise ValueError("Unsupported projection '%s'" % system)

def _eff_lonpole(wcs, zenithal):
	"""LONPOLE with the FITS default applied when unset (None): 0 if
	crval_dec >= theta0 else 180, where theta0 is the native latitude of
	the fiducial point -- 90 for zenithal, 0 for cylindrical projections
	(Calabretta & Greisen 2002 paper II section 2.2)."""
	lp = wcs.wcs.lonpole
	if lp is not None: return float(lp)
	theta0 = 90.0 if zenithal else 0.0
	return 0.0 if float(wcs.wcs.crval[1]) >= theta0 else 180.0

def _native_pole(wcs, system):
	"""Celestial coordinates (ap, dp) of the NATIVE POLE plus the native
	longitude phip of the celestial pole, all in degrees. Zenithal
	projections put the fiducial point (crval) at the native pole directly;
	cylindrical projections have fiducial native coords (phi0,theta0)=(0,0)
	and the pole must be solved for (Calabretta & Greisen 2002 paper II
	section 2.4; the reference delegates this to wcslib via astropy,
	pixell/wcsutils.py:415-516)."""
	a0, d0 = float(wcs.wcs.crval[0]), float(wcs.wcs.crval[1])
	if is_azimuthal(system):
		return a0, d0, _eff_lonpole(wcs, True)
	# Cylindrical (theta0 = 0). An EXPLICIT LONPOLE (e.g. 180 with
	# crval_dec > 0, where cos dp = -sin d0 has solutions) is a valid FITS
	# configuration and is honored as wcslib would.
	phip = _eff_lonpole(wcs, False)
	cphip = np.cos(phip*deg2rad)
	sd0 = np.sin(d0*deg2rad)
	# solutions of cos(dp) = sin(d0)/cos(phip): dp is a declination, so
	# cos(dp) must land in [0, 1] -- outside that the header is invalid
	# (wcslib's celset errors on the same condition)
	if abs(cphip) < 1e-12 or sd0/cphip < -1e-12 or sd0/cphip > 1 + 1e-12:
		raise ValueError("No valid native pole for cylindrical wcs with "
			"crval_dec=%g, lonpole=%g" % (d0, phip))
	# pick the solution closest to LATPOLE (FITS default +90; None = unset)
	dp0 = np.arccos(np.clip(sd0/cphip, 0, 1))*rad2deg
	cands = [d for d in (dp0, -dp0) if abs(d) <= 90 + 1e-9]
	latp = 90.0 if wcs.wcs.latpole is None else float(wcs.wcs.latpole)
	dp = min(cands, key=lambda d: abs(d - latp))
	ap = a0 - np.arctan2(np.sin(phip*deg2rad),
		-np.sin(dp*deg2rad)*cphip)*rad2deg
	return ap, dp, phip

def _rot_native2cel(phi, theta, crval, lonpole, zenithal, pole=None):
	"""Rotate native (phi,theta) [deg] to celestial (lon,lat) [deg].
	Standard spherical rotation, Calabretta & Greisen paper II eq (2).
	pole=(ap, dp, phip) overrides the zenithal assumption that crval is
	the native pole (used for cylindrical crval_dec != 0)."""
	if pole is None:
		if not zenithal:
			# For cylindrical with crval_lat==0 the rotation is a simple shift
			return phi + crval[0], theta
		pole = (crval[0], crval[1], lonpole)
	ap, dp, phip = pole[0]*deg2rad, pole[1]*deg2rad, pole[2]*deg2rad
	p, t = phi*deg2rad, theta*deg2rad
	st, ct = np.sin(t), np.cos(t)
	sdp, cdp = np.sin(dp), np.cos(dp)
	dphi = p - phip
	lat = np.arcsin(np.clip(st*sdp + ct*cdp*np.cos(dphi), -1, 1))
	lon = ap + np.arctan2(-ct*np.sin(dphi), st*cdp - ct*sdp*np.cos(dphi))
	return lon*rad2deg, lat*rad2deg

def _rot_cel2native(lon, lat, crval, lonpole, zenithal, pole=None):
	if pole is None:
		if not zenithal:
			return lon - crval[0], lat
		pole = (crval[0], crval[1], lonpole)
	ap, dp, phip = pole[0]*deg2rad, pole[1]*deg2rad, pole[2]*deg2rad
	a, d = lon*deg2rad, lat*deg2rad
	sd, cd = np.sin(d), np.cos(d)
	sdp, cdp = np.sin(dp), np.cos(dp)
	da = a - ap
	theta = np.arcsin(np.clip(sd*sdp + cd*cdp*np.cos(da), -1, 1))
	phi = phip + np.arctan2(-cd*np.sin(da), sd*cdp - cd*sdp*np.cos(da))
	return phi*rad2deg, theta*rad2deg

def pix2world(wcs, x, y, origin=0):
	"""Pixel (x, y) -> world (lon, lat), degrees."""
	x = np.asarray(x); y = np.asarray(y)
	off = 1 - origin  # FITS crpix is 1-based
	u = (x + off - wcs.wcs.crpix[0])*wcs.wcs.cdelt[0]
	v = (y + off - wcs.wcs.crpix[1])*wcs.wcs.cdelt[1]
	system = get_proj(wcs)
	if system in ["", "plain"]:
		return u + wcs.wcs.crval[0], v + wcs.wcs.crval[1]
	zen = is_azimuthal(system)
	pole = _native_pole(wcs, system) if (not zen and wcs.wcs.crval[1] != 0) \
		else None
	phi, theta = _proj2native(system, u, v, wcs.wcs._pv)
	return _rot_native2cel(phi, theta, wcs.wcs.crval, _eff_lonpole(wcs, zen),
		zen, pole=pole)

def world2pix(wcs, lon, lat, origin=0):
	lon = np.asarray(lon); lat = np.asarray(lat)
	system = get_proj(wcs)
	off = 1 - origin
	if system in ["", "plain"]:
		u = lon - wcs.wcs.crval[0]; v = lat - wcs.wcs.crval[1]
	else:
		zen = is_azimuthal(system)
		pole = _native_pole(wcs, system) if (not zen and wcs.wcs.crval[1] != 0) \
			else None
		phi, theta = _rot_cel2native(lon, lat, wcs.wcs.crval,
			_eff_lonpole(wcs, zen), zen, pole=pole)
		u, v = _native2proj(system, phi, theta, wcs.wcs._pv)
	x = u/wcs.wcs.cdelt[0] + wcs.wcs.crpix[0] - off
	y = v/wcs.wcs.cdelt[1] + wcs.wcs.crpix[1] - off
	return x, y


# ---------------------------------------------------------------------------
# Introspection helpers (reference wcsutils.py:61-260)
# ---------------------------------------------------------------------------
def get_proj(wcs):
	if isinstance(wcs, str): return wcs
	toks = wcs.wcs.ctype[0].split("-")
	return toks[-1].lower() if len(toks) >= 2 else ""

def projection(system, crval=None):
	"""Generate a pixelization-agnostic wcs for the given projection system."""
	system = system.lower()
	if crval is None: crval = default_crval(system)
	crval = np.zeros(2) + crval
	wcs = WCS(naxis=2)
	wcs.wcs.crval = crval
	if system not in ["", "plain"]:
		wcs.wcs.ctype = ["RA---" + system.upper(), "DEC--" + system.upper()]
	return wcs

def describe(wcs):
	sys = get_proj(wcs) or "plain"
	fields = "cdelt:[%.4g,%.4g],crval:[%.4g,%.4g],crpix:[%.2f,%.2f]" % (
		tuple(wcs.wcs.cdelt) + tuple(wcs.wcs.crval) + tuple(wcs.wcs.crpix))
	for p in wcs.wcs.get_pv():
		fields += ",pv[%d,%d]=%.3g" % p
	return "%s:{%s}" % (sys, fields)

def equal(wcs1, wcs2, flags=1, tol=1e-14):
	return wcs1.wcs.compare(wcs2.wcs, flags, tol)

def nobcheck(wcs):
	return wcs  # we never bounds-check

def fix_wcs(wcs, axis=0):
	"""Returns a new WCS with the crval of the given axis put in the range
	[0,360) by adjusting crpix accordingly (reference wcsutils.fix_wcs:348)."""
	res = wcs.deepcopy()
	w = 360.0
	val = res.wcs.crval[axis]
	n = np.floor(val/w)
	res.wcs.crval[axis] = val - n*w
	return res

def fix_cdelt(wcs):
	"""Return a wcs with unit cd matrix semantics (no-op here: we store cdelt)."""
	return wcs.deepcopy()

def is_azimuthal(system):
	if not isinstance(system, str): system = get_proj(system)
	return system.lower() in ["arc", "zea", "sin", "tan", "azp", "slp", "stg", "zpn", "air"]

def is_plain(wcs):
	return get_proj(wcs) in ["", "plain"]

def is_cyl(wcs):
	return get_proj(wcs) in ["cyp", "cea", "car", "mer"]

def is_separable(wcs):
	return is_cyl(wcs) and wcs.wcs.crval[1] == 0

def is_compatible(wcs1, wcs2, tol=1e-3):
	"""Whether the two wcses are (shifted) versions of the same pixelization."""
	if get_proj(wcs1) != get_proj(wcs2): return False
	if np.max(np.abs(np.asarray(wcs1.wcs.cdelt) - wcs2.wcs.cdelt))/np.min(np.abs(wcs1.wcs.cdelt)) > tol:
		return False
	crdelt = np.asarray(wcs1.wcs.crval) - wcs2.wcs.crval
	cpdelt = np.asarray(wcs1.wcs.crpix) - wcs2.wcs.crpix
	subpix = (crdelt/wcs1.wcs.cdelt - cpdelt + 0.5) % 1 - 0.5
	return np.max(np.abs(subpix)) <= tol

def parse_system(system, variant=None):
	toks = system.split(":")
	if len(toks) > 1: return toks[0].lower(), toks[1]
	return toks[0].lower(), variant

def scale(wcs, scale=1, rowmajor=False, corner=True):
	"""Scale the pixel density of the wcs by the given per-axis factor."""
	scale = np.zeros(2) + scale
	if rowmajor: scale = scale[::-1]
	wcs = wcs.deepcopy()
	if corner: wcs.wcs.crpix -= 0.5
	wcs.wcs.crpix = wcs.wcs.crpix*scale
	wcs.wcs.cdelt = wcs.wcs.cdelt/scale
	if corner: wcs.wcs.crpix += 0.5
	return wcs

def expand_res(res, signs=None, flip=False):
	if res is None: return res
	if signs is None: signs = [1, -1] if flip else [-1, 1]
	res = np.atleast_1d(res)
	if flip: res, signs = res[::-1], list(signs)[::-1]
	if res.size == 1: res = np.array(signs)*res[0]
	return res

def default_crval(system):
	return [0, 90] if is_azimuthal(system) else [0, 0]

def default_extent(system):
	system = system.lower()
	if system in ["", "plain"]: return [1, 1], None
	if   system == "car": return [360, 180], None
	elif system == "cea": return [360, 360/np.pi], None
	elif system == "mer": return [360, 360], None
	elif system == "arc": return [360, 360], 180.
	elif system == "zea": return [720/np.pi, 720/np.pi], 180.
	elif system == "sin": return [360/np.pi, 360/np.pi], 180.
	elif system == "tan": return [360, 360], 180.
	else: raise ValueError("Unsupported system '%s'" % str(system))

def default_variant(system):
	system = system.lower()
	return "fejer1" if system in ["car", "plain", ""] else "any"

def is_periodic(system):
	system = system.lower()
	if is_azimuthal(system) or system in ["", "plain"]:
		return [False, False]
	return [True, False]

def parse_variant(name):
	"""Parse a pixelization variant name into pixel-offset rules
	[[x_left,x_right],[y_left,y_right]] (reference wcsutils.parse_variant:260)."""
	name = name.lower()
	if   name == "safe":   rule = "hh,hh"
	elif name == "fejer1": rule = "00,hh"
	elif name == "cc":     rule = "00,00"
	elif name == "any":    rule = "**,**"
	else: rule = name
	toks = rule.split(",")
	if len(toks) != 2 or len(toks[0]) != 2 or len(toks[1]) != 2:
		raise ValueError("Could not recognize pixelization variant '%s'" % str(name))
	left  = {"0": 0, "h": 0.5, "*": None}
	right = {"0": 0, "h": -0.5, "*": None}
	try:
		return [[left[tok[0]], right[tok[1]]] for tok in toks]
	except KeyError:
		raise ValueError("Invalid character in rule '%s'" % str(rule))

class PixelizationError(Exception): pass

def pixelize_1d(w, n=None, res=None, offs=None, periodic=False, adjust=False,
		sign=1, tol=1e-6, eps=1e-6):
	"""Distribute pixels along an interval of width w with given edge offsets.
	Returns (coord_first_center, coord_last_center, n, off_left, off_right)."""
	o1, o2 = offs if offs is not None else (None, None)
	if res is not None:
		if res < 0: res, sign = -res, -sign
		if o1 is None and o2 is None:
			o1 = o2 = 0; adjust = True
		if o2 is None:
			n = int(w/res + 1 - o1 + eps)
			o2 = w/res - (n - 1) - o1
		elif o1 is None:
			n = int(w/res + 1 + o2 + eps)
			o1 = w/res - (n - 1) + o2
		else:
			n = w/res + 1 - o1 + o2
			nint_ = utils.nint(n)
			if adjust: n = nint_
			elif abs(n - nint_) > tol:
				raise PixelizationError(
					"Resolution %g does not evenly divide interval %g with offsets (%s,%s)"
					% (res, w, str(o1), str(o2)))
			else: n = nint_
	else:
		if o1 is None: o1 = 0
		if o2 is None: o2 = 0
		res = w/(n - 1 + o1 - o2) if (n - 1 + o1 - o2) != 0 else w
	n = int(n)
	# Coordinates of first and last pixel centers, interval centered on 0
	c1 = -w/2 + o1*res
	c2 = c1 + (n - 1)*res
	return c1*sign if sign > 0 else -c2, (c2 if sign > 0 else -c1), n, o1, -o2

def pixelization(pwcs, shape=None, res=None, variant=None):
	"""Add full-sky pixel information to a projection-only wcs.
	Returns ((ny,nx), wcs)."""
	system = get_proj(pwcs)
	extent, lonpole = default_extent(system)
	variant = variant or default_variant(system)
	offs = parse_variant(variant)
	periodic = is_periodic(system)
	if shape is None:
		res = expand_res(res)
		ra1, ra2, nx, ox1, ox2 = pixelize_1d(extent[0], res=abs(res[0]), offs=offs[0],
			periodic=periodic[0], sign=int(np.sign(res[0])))
		dec1, dec2, ny, oy1, oy2 = pixelize_1d(extent[1], res=abs(res[1]), offs=offs[1],
			periodic=periodic[1], sign=int(np.sign(res[1])))
	elif res is None:
		ra1, ra2, nx, ox1, ox2 = pixelize_1d(extent[0], n=shape[-1], offs=offs[0],
			periodic=periodic[0])
		dec1, dec2, ny, oy1, oy2 = pixelize_1d(extent[1], n=shape[-2], offs=offs[1],
			periodic=periodic[1])
	else:
		raise ValueError("Either res or shape must be given to build a pixelization")
	owcs = pwcs.deepcopy()
	owcs.wcs.cdelt = np.array([(ra2 - ra1)/(nx - 1) if nx > 1 else extent[0],
		(dec2 - dec1)/(ny - 1) if ny > 1 else extent[1]])
	owcs.wcs.crpix = np.array([1 + ((nx - 1) - ox2 - ox1)/2, 1 + ((ny - 1) - oy2 - oy1)/2])
	if lonpole is not None:
		owcs.wcs.lonpole = lonpole
	return (ny, nx), owcs


# ---------------------------------------------------------------------------
# Per-projection builders (reference wcsutils.py:415-516).
# pos is [{from,to},{ra,dec}] or [{ra,dec}] in degrees, res in degrees.
# ---------------------------------------------------------------------------
def _default_pos(pos):
	pos = np.asarray(pos, float)
	return pos

def explicit(naxis=2, **args):
	wcs = WCS(naxis=naxis)
	for key in args:
		setattr(wcs.wcs, key, np.asarray(args[key], float)
			if key in ["crval", "crpix", "cdelt"] else args[key])
	return wcs

def _build_cyl(system, pos, res=None, shape=None, rowmajor=False, ref=None):
	"""Common builder for cylindrical projections."""
	pos, res = validate_pos_res(pos, res, rowmajor)
	wcs = WCS(naxis=2)
	if system not in ["", "plain"]:
		wcs.wcs.ctype = ["RA---" + system.upper(), "DEC--" + system.upper()]
	if pos.ndim == 1:  # center + shape
		assert shape is not None, "Shape must be specified for center-based geometry"
		if res is None: raise ValueError("res needed with center pos")
		wcs.wcs.cdelt = np.array([-abs(res[0]), abs(res[1])]) if system else np.array(res)
		crval = np.array([pos[0], 0.0]) if system else pos
		wcs.wcs.crval = crval
		# center pixel at pos
		nx, ny = shape[-1], shape[-2]
		cx, cy = world2pix(wcs, pos[0], pos[1])
		wcs.wcs.crpix = np.array([ (nx+1)/2. - float(cx), (ny+1)/2. - float(cy) ])
	else:  # corner box [{from,to},{ra,dec}]
		if res is None:
			assert shape is not None
			res = (pos[1] - pos[0])/np.array([shape[-1], shape[-2]])
		wcs.wcs.cdelt = np.array(res, float)
		wcs.wcs.crval = np.array([pos[0, 0], 0.0]) if system else pos[0].astype(float)
		wcs.wcs.crpix = np.ones(2)
		# put the first pixel center at pos[0] (+half-pixel into the box)
		x0, y0 = world2pix(wcs, pos[0, 0], pos[0, 1])
		wcs.wcs.crpix = wcs.wcs.crpix - np.array([float(x0) + 0.5*np.sign(res[0])*0,
			float(y0)]) + np.array([-float(x0), -float(y0)])*0
		wcs.wcs.crpix = np.array([1 - float(x0), 1 - float(y0)])
		if ref is not None and not streq(ref, "standard"):
			_apply_ref(wcs, ref)
		elif streq(ref, "standard"):
			_apply_ref(wcs, (0.0, 0.0))
	return wcs

def _apply_ref(wcs, ref):
	"""Shift crpix so that the world point ref=(lon,lat) deg lands on an
	integer pixel coordinate (reference geometry 'standard point' tweak)."""
	x, y = world2pix(wcs, ref[0], ref[1])
	wcs.wcs.crpix = wcs.wcs.crpix + (np.round([float(x), float(y)]) - [float(x), float(y)])

def validate_pos_res(pos, res, rowmajor):
	pos = np.asarray(pos, float)
	if rowmajor:
		pos = pos[..., ::-1]
		if res is not None:
			res = np.atleast_1d(np.asarray(res, float))
			if res.size == 2: res = res[::-1]
	if res is not None:
		res = np.atleast_1d(np.asarray(res, float))
		if res.size == 1:
			res = np.array([-res[0], res[0]])
	return pos, res

def plain(pos, res=None, shape=None, rowmajor=False, ref=None):
	pos, res = validate_pos_res(pos, res, rowmajor)
	if res is not None and pos.ndim == 2:
		res = np.abs(res)*np.sign(pos[1]-pos[0])
	wcs = WCS(naxis=2)
	wcs.wcs.ctype = ["", ""]
	if pos.ndim == 1:
		wcs.wcs.cdelt = np.abs(res)
		wcs.wcs.crval = pos
		nx, ny = shape[-1], shape[-2]
		wcs.wcs.crpix = np.array([(nx+1)/2., (ny+1)/2.])
	else:
		if res is None:
			res = (pos[1]-pos[0])/np.array([shape[-1], shape[-2]])
		wcs.wcs.cdelt = res
		wcs.wcs.crval = pos[0]
		wcs.wcs.crpix = np.array([0.5, 0.5])  # first pixel center half pix in
	return wcs

def car(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_cyl("car", pos, res, shape, rowmajor, ref)
def cea(pos, res=None, shape=None, rowmajor=False, ref=None, lam=None):
	wcs = _build_cyl("cea", pos, res, shape, rowmajor, ref)
	if lam is None: lam = 1.0
	wcs.wcs._pv[(2, 1)] = float(lam)
	return wcs
def mer(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_cyl("mer", pos, res, shape, rowmajor, ref)

def _build_zenithal(system, pos, res=None, shape=None, rowmajor=False, ref=None):
	pos, res = validate_pos_res(pos, res, rowmajor)
	assert pos.ndim == 1, "Zenithal projections need a center position"
	wcs = WCS(naxis=2)
	wcs.wcs.ctype = ["RA---" + system.upper(), "DEC--" + system.upper()]
	wcs.wcs.crval = np.array(pos, float)
	wcs.wcs.cdelt = np.array([-abs(res[0]), abs(res[1])]) if res is not None else np.array([-1., 1.])
	nx, ny = (shape[-1], shape[-2]) if shape is not None else (1, 1)
	wcs.wcs.crpix = np.array([(nx+1)/2., (ny+1)/2.])
	wcs.wcs.lonpole = 180.0
	return wcs

def tan(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_zenithal("tan", pos, res, shape, rowmajor, ref)
def zea(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_zenithal("zea", pos, res, shape, rowmajor, ref)
def sin(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_zenithal("sin", pos, res, shape, rowmajor, ref)
def arc(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_zenithal("arc", pos, res, shape, rowmajor, ref)
def air(pos, res=None, shape=None, rowmajor=False, ref=None):
	return _build_zenithal("air", pos, res, shape, rowmajor, ref)

systems = {"plain": plain, "": plain, "car": car, "cea": cea, "mer": mer,
	"tan": tan, "zea": zea, "sin": sin, "arc": arc, "air": air}

def build(pos, res=None, shape=None, rowmajor=False, system="car", ref=None, **kwargs):
	"""Construct a wcs for the given projection system covering pos with
	resolution res (degrees)."""
	system, variant = parse_system(system)
	if system not in systems:
		raise ValueError("Unknown projection system '%s'" % system)
	return systems[system](pos, res=res, shape=shape, rowmajor=rowmajor, ref=ref, **kwargs)

def finalize(wcs, pos, res=None, shape=None, ref=None):
	return wcs


def extent2bounds(extent):
	"""(reference wcsutils.extent2bounds)."""
	return [[-e/2, e/2] for e in extent]

def angdist(lon1, lat1, lon2, lat2):
	"""Angular distance between lonlat points (reference wcsutils.angdist)."""
	return np.arccos(np.clip(np.cos(lat1)*np.cos(lat2)*(np.cos(lon1)*np.cos(lon2)
		+ np.sin(lon1)*np.sin(lon2)) + np.sin(lat1)*np.sin(lat2), -1, 1))

def recenter_cyl_x(wcs, x):
	"""Move a cylindrical wcs reference point along the equator to pixel x
	(1-based) (reference wcsutils.recenter_cyl_x)."""
	if not is_separable(wcs):
		raise ValueError("recenter_cyl requires a cylindrical wcs with crval on the equator")
	owcs = wcs.deepcopy()
	owcs.wcs.crval = list(owcs.wcs.crval)
	owcs.wcs.crpix = list(owcs.wcs.crpix)
	owcs.wcs.crval[0] = wcs.wcs.crval[0] + (x - wcs.wcs.crpix[0])*wcs.wcs.cdelt[0]
	owcs.wcs.crpix[0] = x
	return owcs

def recenter_cyl_ra(wcs, ra):
	"""Move a cylindrical wcs reference point to the given ra (degrees)
	(reference wcsutils.recenter_cyl_ra)."""
	return recenter_cyl_x(wcs, wcs.wcs.crpix[0] + (ra - wcs.wcs.crval[0])/wcs.wcs.cdelt[0])

def center_cyl_wcs(wcs, shape=None, off=0.5):
	"""Move the reference point of a cylindrical wcs to the middle of the
	patch (reference wcsutils.center_cyl_wcs)."""
	if not is_separable(wcs):
		raise ValueError("Can't fix wcs for non-separable wcs")
	n = abs(360/wcs.wcs.cdelt[0]) if shape is None else shape[-1]
	x = (n - 1)/2 + 1
	ra = wcs.wcs.crval[0] + (x - wcs.wcs.crpix[0])*wcs.wcs.cdelt[0]
	ra = (ra - off) % 360 + off
	owcs = wcs.deepcopy()
	owcs.wcs.crval = list(owcs.wcs.crval)
	owcs.wcs.crpix = list(owcs.wcs.crpix)
	owcs.wcs.crval[0] = ra
	owcs.wcs.crpix[0] = x
	return owcs

def validate(pos, res, shape, rowmajor=False, default_dirs=[1, -1]):
	"""Normalize (pos, res, shape) geometry arguments (reference
	wcsutils.validate)."""
	pos = np.asarray(pos)
	if pos.shape != (2,) and pos.shape != (2, 2):
		raise ValueError("pos must be [2] or [2,2]")
	if res is None and shape is None:
		raise ValueError("At least one of res and shape must be specified")
	if res is not None:
		res = np.atleast_1d(res)
		if res.shape == (1,):
			res = (np.zeros(2) + res) if pos.shape == (2, 2) else np.array(default_dirs)*res
		elif res.shape != (2,):
			raise ValueError("res must be num or [2]")
	if rowmajor:
		pos = pos[..., ::-1]
		if shape is not None: shape = shape[::-1]
		if res is not None: res = res[::-1]
	if shape is not None: shape = shape[:2]
	if res is None and pos.ndim != 2:
		raise ValueError("pos must be a bounding box if res is not specified")
	return pos, res, shape
