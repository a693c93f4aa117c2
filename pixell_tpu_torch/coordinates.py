"""Celestial coordinate transforms (counterpart of pixell_tpu/coordinates.py).

Host float64 numpy for every system the reference has: the fixed-matrix
systems (equ / cel, gal, ecl), the site-relative chain (hor, tele, bore,
through the sidereal rotation and the site's base tilt), recentered specs
([base, [center, restore]] or the string "base:ref[:refsys]"), and the
polarization angle and magnification of a transform by finite offsets
(transform_meta). Coordinates given as a tensor stay on its device in
float64 where both systems are fixed-matrix ones, recentered or not: the
whole transform is one rotation matrix, built on the host, applied on the
device (thumbnails and the spline reprojection transform millions of
points); other systems go through the host and come back as a tensor.
The ephemeris objects (ephem_pos, interpol_pos, and a centre given by a
body's name, "equ:Jupiter") take their positions from ephem.py's default
ephemeris, on the host.
"""
from __future__ import annotations
import numpy as np
import torch
from . import utils

# Galactic pole/center in equatorial (J2000) coordinates (IAU definition)
_GAL_POLE_RA  = 192.85948*utils.degree
_GAL_POLE_DEC = 27.12825*utils.degree
_GAL_CEN_RA   = 266.40499*utils.degree
_GAL_CEN_DEC  = -28.93617*utils.degree

# Ecliptic obliquity (J2000)
_ECL_OBL = 23.4392911*utils.degree


def euler_mat(euler_angles, kind="zyz", xp=np):
	"""Rotation matrix for the given Euler angles (pixell_tpu.coordinates.
	euler_mat), numpy float64; xp is accepted and ignored."""
	alpha, beta, gamma = euler_angles
	R = utils.rotmatrix(alpha, kind[0])
	R = R @ utils.rotmatrix(beta, kind[1])
	R = R @ utils.rotmatrix(gamma, kind[2])
	return R

def _equ2gal_mat():
	"""Rotation matrix equatorial -> galactic, built from the galactic pole
	and center anchor directions (orthonormalized)."""
	def n(ra, dec):
		return np.array([np.cos(dec)*np.cos(ra), np.cos(dec)*np.sin(ra), np.sin(dec)])
	z = n(_GAL_POLE_RA, _GAL_POLE_DEC)
	x = n(_GAL_CEN_RA, _GAL_CEN_DEC)
	x = x - np.dot(x, z)*z
	x /= np.linalg.norm(x)
	y = np.cross(z, x)
	return np.array([x, y, z])

_MATS = {}
def _get_mat(isys, osys):
	key = (isys, osys)
	if key in _MATS: return _MATS[key]
	def base(sys):
		if sys in ["equ", "cel", "icrs", "c", "fk5", "j2000"]: return np.eye(3)
		if sys in ["gal", "g", "galactic"]: return _equ2gal_mat()
		if sys in ["ecl", "e", "ecliptic"]: return utils.rotmatrix(_ECL_OBL, "x").T
		raise ValueError("Unknown coordinate system '%s'" % sys)
	R = base(osys) @ base(isys).T
	_MATS[key] = R
	return R

def _rot(R, coords):
	"""coords [{ra, dec}, ...] rotated by the matrix R [3, 3]: numpy, or a
	float64 tensor on the tensor's device."""
	if not isinstance(coords, torch.Tensor):
		rect = utils.ang2rect(coords, axis=0)
		shape = rect.shape
		rect = np.tensordot(R, rect.reshape(3, -1), 1).reshape(shape)
		return utils.rect2ang(rect, axis=0)
	ra, dec = coords.to(torch.float64)
	cd = torch.cos(dec)
	rect = torch.stack([cd*torch.cos(ra), cd*torch.sin(ra), torch.sin(dec)])
	Rt = torch.as_tensor(np.asarray(R, np.float64), device=coords.device)
	x, y, z = torch.tensordot(Rt, rect.reshape(3, -1), 1).reshape(rect.shape)
	return torch.stack([torch.atan2(y, x), torch.atan2(z, torch.sqrt(x*x + y*y))])

def _unwind(a):
	"""utils.unwind of a numpy array or (through the host) a tensor."""
	if not isinstance(a, torch.Tensor): return utils.unwind(a)
	return torch.from_numpy(utils.unwind(a.cpu().numpy())).to(a.device)

def euler_rot(euler_angles, coords, kind="zyz"):
	"""Rotate coords[{ra,dec},...] by the given euler angles."""
	coords = coords if isinstance(coords, torch.Tensor) else np.asarray(coords)
	return _rot(euler_mat(euler_angles, kind), coords)

def transform_simple(from_sys, to_sys, coords, unwind=False):
	"""Fixed-matrix transform between equ/gal/ecl."""
	coords = coords if isinstance(coords, torch.Tensor) else np.asarray(coords)
	res = _rot(_get_mat(getsys(from_sys), getsys(to_sys)), coords[:2])
	if unwind: res = _cat([_unwind(res[:1]), res[1:]])
	return res

def _cat(rows):
	return torch.cat(rows, 0) if isinstance(rows[0], torch.Tensor) else np.concatenate(rows, 0)

def _device_matrix(from_info, to_info):
	"""The one rotation matrix of a transform between fixed-matrix systems,
	recentered or not (decenter, base change, recenter), or None where a
	system is not one."""
	(fs, from_ref), (ts, to_ref) = from_info, to_info
	if fs not in _MAT_SYS or ts not in _MAT_SYS: return None
	R = np.eye(3) if fs == ts else _get_mat(fs, ts)
	if from_ref is not None: R = R @ euler_mat(_decenter_angles(from_ref[0], from_ref[1]))
	if to_ref is not None: R = euler_mat(_recenter_angles(to_ref[0], to_ref[1])) @ R
	return R

def transform(from_sys, to_sys, coords, time=55500, site=None, pol=None,
		mag=None, bore=None, unwind=False):
	"""Transform coords[{ra,dec},...] (radians) between coordinate systems
	(pixell_tpu.coordinates.transform). Systems: equ/cel, gal, ecl, hor,
	tele, bore, plus recentered specs [base, [center, restore]] or the
	string syntax "base:ref[:refsys]". With pol (or a 3rd input row), a
	polarization-rotation row is appended; with mag (or a 4th row), a
	magnification row. A tensor stays on its device (float64) between
	fixed-matrix systems; other systems are transformed on the host."""
	if site is None: site = default_site
	from_info = getsys_full(from_sys, time, site, bore=bore)
	to_info   = getsys_full(to_sys, time, site, bore=bore)
	if isinstance(coords, torch.Tensor):
		R = _device_matrix(from_info, to_info)
		if R is None:
			res = transform(from_info, to_info, coords.cpu().numpy(), time=time, site=site, pol=pol,
				mag=mag, bore=bore, unwind=unwind)
			return torch.from_numpy(np.asarray(res)).to(coords.device)
		coords = coords.to(torch.float64)
		transfunc = lambda c: _rot(R, c)
	else:
		coords = np.asarray(coords, float)
		transfunc = lambda c: transform_raw(from_info, to_info, c, time=time, site=site, bore=bore)
	simple = (from_info[1] is None and to_info[1] is None
		and from_info[0] in _MAT_SYS and to_info[0] in _MAT_SYS)
	ihand = get_handedness(from_info[0])
	ohand = get_handedness(to_info[0])
	fields = []
	if pol: fields.append("ang")
	if mag: fields.append("mag")
	if pol is None and mag is None:
		if len(coords) > 2: fields.append("ang")
		if len(coords) > 3: fields.append("mag")
	if not fields and simple:
		res = transform_simple(from_info[0], to_info[0], coords)
		if unwind: res = _cat([_unwind(res[:1]), res[1:]])
		return res
	meta = transform_meta(transfunc, coords[:2], fields=fields)
	if "ang" in fields:
		# healpix polarization convention (pixell_tpu.coordinates.transform :47-49)
		if ihand != ohand: meta.ang = meta.ang - np.pi
		if ohand != "L":   meta.ang = -meta.ang
	rows = [meta.ocoord[0], meta.ocoord[1]]
	for f in fields:
		if f == "ang":
			rows.append((coords[2] + meta.ang) if len(coords) > 2 else meta.ang)
		elif f == "mag":
			rows.append((coords[3]*meta.mag) if len(coords) > 3 else meta.mag)
	if unwind: rows[0] = _unwind(rows[0])
	if isinstance(coords, torch.Tensor): return torch.stack(rows)
	return np.array(np.broadcast_arrays(*rows), float)

def transform_meta(transfun, coords, fields=["ang", "mag"], offset=5e-7):
	"""Metadata of a coordinate transform: output coords plus the induced
	local rotation (ang) and magnification (mag), via finite offsets
	(pixell_tpu.coordinates.transform_meta); numpy, or tensors on their
	device."""
	from .bunch import Bunch
	if "mag_brute" in fields: ntrans = 3
	elif "ang" in fields: ntrans = 2
	else: ntrans = 1
	tensor = isinstance(coords, torch.Tensor)
	xp = torch if tensor else np
	if not tensor: coords = np.asarray(coords)
	offsets = np.array([[0, 0], [1, 0], [0, 1]])*offset
	ocoords = []
	for i in range(ntrans):
		off = offsets[i].reshape((2,) + (1,)*(coords.ndim - 1))
		if tensor: off = torch.from_numpy(off).to(coords.device)
		ocoords.append(xp.asarray(transfun(coords + off)))
	ocoords = xp.stack(ocoords)
	res = Bunch()
	res.icoord = coords
	res.ocoord = ocoords[0]
	diff = utils.rewind(ocoords[1:] - ocoords[0, None]) if ntrans > 1 else None
	if "ang" in fields:
		# IAU tangent-plane angle of the transformed ra-offset direction
		phiscale = xp.cos(ocoords[0, 1])
		res.ang = xp.arctan2(diff[0, 1], diff[0, 0]*phiscale)
	if "mag" in fields:
		res.mag = xp.cos(res.icoord[1])/xp.cos(res.ocoord[1])
	if "mag_brute" in fields:
		def tri_area(d):
			return 0.5*xp.abs(d[0, 0]*d[1, 1] - d[0, 1]*d[1, 0])
		res.mag = (tri_area(diff).T/tri_area(offsets[1:] - offsets[0]).T).T
	return res

_MAT_SYS = ["equ", "gal", "ecl"]

def getsys(sys):
	if not isinstance(sys, str): return sys
	s = sys.lower().split(":")[0]
	aliases = {"c": "equ", "cel": "equ", "icrs": "equ", "equ": "equ", "fk5": "equ",
		"j2000": "equ",
		"g": "gal", "gal": "gal", "galactic": "gal",
		"e": "ecl", "ecl": "ecl", "ecliptic": "ecl",
		"hor": "altaz", "altaz": "altaz", "tele": "tele", "bore": "bore"}
	if s in aliases: return aliases[s]
	raise ValueError("Unknown coordinate system '%s'" % sys)

def getsys_full(sys, time=None, site=None, bore=None):
	"""Expanded coordinate-system syntax base[:ref[:refsys]]
	(pixell_tpu.coordinates.getsys_full): a system optionally recentered on a
	position ("10_20" in degrees), where the reference point may itself be
	given in another system. Returns [base, ref] with ref None or
	[ref_coords, restore_flag]; ref_coords has 2 rows (recenter on zenith)
	or 4 (move point A to point B). A centre may be an ephemeris object's
	name ("Jupiter"), at time (mjd; 55500 where None)."""
	if site is None: site = default_site
	if isinstance(sys, str):
		sys = sys.split(":", 1)
	else:
		try: sys = list(sys)
		except TypeError: sys = [sys]
	if len(sys) < 2: sys += [None]*(2 - len(sys))
	base, ref = sys
	sidelobe = False
	if base == "sidelobe":
		base = "bore"
		sidelobe = True
	base = getsys(base)
	if ref is None: return [base, None]
	if isinstance(ref, str):
		prevsys = base
		ref_expanded = []
		for ref_refsys in ref.split("/"):
			toks = ref_refsys.split(":")
			r = toks[0]
			refsys = getsys(toks[1]) if len(toks) > 1 else prevsys
			try:
				r = np.asarray([float(w) for w in r.split("_")])*utils.degree
				if r.ndim != 1 or len(r) != 2: raise ValueError("a reference point has two coordinates")
				r = transform_raw([refsys, None], [base, None], r[:, None],
					time=time, site=site, bore=bore)
			except ValueError:
				r = ephem_pos(r, time if time is not None else 55500)
				r = transform_raw(["equ", None], [base, None], np.asarray(r).reshape(2, -1), time=time,
					site=site, bore=bore)
			ref_expanded += list(np.asarray(r).reshape(2, -1)[:, 0])
			prevsys = refsys
		ref = [np.array(ref_expanded), sidelobe]
	elif not (isinstance(ref, (list, tuple)) and len(ref) == 2
			and np.ndim(ref[1]) == 0 and isinstance(ref[1], (bool, np.bool_))):
		# bare coordinates: wrap with the sidelobe flag
		ref = [np.asarray(ref, float), sidelobe]
	else:
		ref = [np.asarray(ref[0], float), bool(ref[1])]
	return [base, ref]

def _recenter_angles(center, restore=False):
	"""The zyz Euler angles of recenter(., center, restore)."""
	center = np.asarray(center)
	if len(center) == 4:
		ra0, dec0, ra1, dec1 = center
	else:
		ra0, dec0 = center[0], center[1]
		ra1, dec1 = ra0*0, dec0*0 + np.pi/2
	if restore: ra1 = ra1 + ra0
	return [ra1, dec0 - dec1, -ra0]

def _decenter_angles(center, restore=False):
	"""The zyz Euler angles of decenter(., center, restore)."""
	ra1, ddec, mra0 = _recenter_angles(center, restore)
	return [-mra0, -ddec, -ra1]

def recenter(angs, center, restore=False):
	"""Rotate coordinates so that center[{ra,dec}] is at the north pole
	(pixell_tpu.coordinates.recenter). If center has 4 components
	[ra0,dec0,ra1,dec1], rotates (ra0,dec0) to (ra1,dec1)."""
	return euler_rot(_recenter_angles(center, restore), angs, kind="zyz")

def decenter(angs, center, restore=False):
	"""Inverse of recenter."""
	return euler_rot(_decenter_angles(center, restore), angs, kind="zyz")


# ---------------------------------------------------------------------------
# Earth-fixed systems: equ <-> hor for a site and time by the sidereal-time
# rotation (no precession, nutation or aberration: arcminute accuracy, as in
# pixell_tpu/coordinates.py)
# ---------------------------------------------------------------------------
def gmst(mjd):
	"""Greenwich mean sidereal time (radians) at the given MJD (UT1~UTC)."""
	mjd = np.asarray(mjd, float)
	d = mjd - 51544.5
	gmst_hours = 18.697374558 + 24.06570982441908*d
	return (gmst_hours % 24)/24*2*np.pi

def equ2hor(coords, mjd, site):
	"""[{ra,dec},...] -> [{az,el},...] for the given site (Bunch with
	lat/lon in degrees) and time."""
	from . import sites as sites_mod
	if isinstance(site, str): site = sites_mod.get(site)
	coords = np.asarray(coords)
	ra, dec = coords[0], coords[1]
	lat = site.lat*utils.degree
	lon = site.lon*utils.degree
	lst = gmst(mjd) + lon
	H = lst - ra  # hour angle
	sel = np.sin(dec)*np.sin(lat) + np.cos(dec)*np.cos(lat)*np.cos(H)
	el = np.arcsin(np.clip(sel, -1, 1))
	az = np.arctan2(-np.sin(H)*np.cos(dec),
		np.sin(dec)*np.cos(lat) - np.cos(dec)*np.sin(lat)*np.cos(H))
	return np.stack([az % (2*np.pi), el])

def hor2equ(coords, mjd, site):
	"""[{az,el},...] -> [{ra,dec},...]."""
	from . import sites as sites_mod
	if isinstance(site, str): site = sites_mod.get(site)
	coords = np.asarray(coords)
	az, el = coords[0], coords[1]
	lat = site.lat*utils.degree
	lon = site.lon*utils.degree
	sdec = np.sin(el)*np.sin(lat) + np.cos(el)*np.cos(lat)*np.cos(az)
	dec = np.arcsin(np.clip(sdec, -1, 1))
	H = np.arctan2(-np.sin(az)*np.cos(el),
		np.sin(el)*np.cos(lat) - np.cos(el)*np.sin(lat)*np.cos(az))
	lst = gmst(mjd) + lon
	ra = (lst - H) % (2*np.pi)
	return np.stack([ra, dec])


class default_site:
	"""ACT-like site (pixell_tpu.coordinates.default_site)."""
	lat = -22.9585
	lon = -67.7876
	alt = 5188.0
	T = 273.15
	P = 550.0
	hum = 0.2
	freq = 150.0
	lapse = 0.0065
	base_tilt = 0.0107693
	base_az = -114.9733961

def hor2cel(coord, time, site=default_site, copy=True):
	"""[{az,el},...] -> [{ra,dec},...] at the given mjd times (sidereal
	approximation)."""
	coord = np.array(coord, copy=copy)
	res = hor2equ(coord[:2], np.asarray(time), site)
	coord[:2] = res
	return coord

def cel2hor(coord, time, site=default_site, copy=True):
	coord = np.array(coord, copy=copy)
	res = equ2hor(coord[:2], np.asarray(time), site)
	coord[:2] = res
	return coord

def tele2hor(coord, site=default_site, copy=True):
	"""Telescope -> horizontal coordinates via the base tilt."""
	coord = np.array(coord, copy=copy)
	return euler_rot([site.base_az*utils.degree, site.base_tilt*utils.degree,
		-site.base_az*utils.degree], coord)

def hor2tele(coord, site=default_site, copy=True):
	coord = np.array(coord, copy=copy)
	return euler_rot([site.base_az*utils.degree, -site.base_tilt*utils.degree,
		-site.base_az*utils.degree], coord)

def tele2bore(coord, bore, copy=True):
	"""To boresight-relative coordinates."""
	return recenter(np.array(coord, copy=copy), bore)

def bore2tele(coord, bore, copy=True):
	"""From boresight-relative coordinates."""
	return decenter(np.array(coord, copy=copy), bore)

def nohor(sys):
	return sys if sys not in ["altaz", "tele", "bore", "hor"] else "icrs"

def get_handedness(sys):
	"""IAU handedness of the system as seen from inside the sphere."""
	return "R" if sys in ["altaz", "tele", "bore", "hor"] else "L"

def make_mapping(dict_):
	return {value: key for key in dict_ for value in dict_[key]}

def ephem_pos(name, mjd):
	"""The equatorial position [{ra, dec}, ...] (radians) of a named
	ephemeris object at mjd (pixell_tpu.coordinates.ephem_pos), from
	ephem's default ephemeris."""
	from . import ephem as ephem_mod
	return ephem_mod.ephem_pos(name, mjd)

def interpol_pos(from_sys, to_sys, name_or_pos, mjd, site=default_site, dt=10):
	"""The positions [{ra, dec}, ...] of a moving object (a name) or a fixed
	one ([{ra, dec}]) transformed at the times mjd: transformed at samples
	dt seconds apart over their range and interpolated linearly
	(pixell_tpu.coordinates.interpol_pos)."""
	mjd = np.asarray(mjd)
	box = utils.widen_box(np.array([np.min(mjd), np.max(mjd)]), 0.01)
	sub_nsamp = max(3, int((box[1] - box[0])*24.*3600/dt))
	sub_mjd = np.linspace(box[0], box[1], sub_nsamp, endpoint=True)
	if isinstance(name_or_pos, str):
		sub_from = ephem_pos(name_or_pos, sub_mjd)
	else:
		sub_from = np.zeros([2, sub_nsamp])
		sub_from[:] = np.asarray(name_or_pos)[:, None]
	sub_to = transform_raw(from_sys, to_sys, sub_from, time=sub_mjd, site=site)
	ra = utils.unwind(sub_to[0])
	return np.array([np.interp(mjd, sub_mjd, ra) % (2*np.pi), np.interp(mjd, sub_mjd, sub_to[1])])

def transform_raw(from_sys, to_sys, coords, time=None, site=None, bore=None):
	"""Transform between equ/gal/ecl/hor(altaz)/tele/bore systems, including
	recentered system specs, handling the time-dependent hor chain
	(pixell_tpu.coordinates.transform_raw). from_sys/to_sys may be raw specs
	or pre-parsed [base, ref] pairs from getsys_full."""
	if site is None: site = default_site
	coords = np.array(np.asarray(coords, float))[:2]
	def parse(sys):
		if isinstance(sys, (list, tuple)) and len(sys) == 2 and (
				sys[1] is None or isinstance(sys[1], (list, tuple))
				and len(sys[1]) == 2 and np.ndim(sys[1][1]) == 0):
			# may already be a parsed [base, ref]
			try: return [getsys(sys[0]), sys[1]]
			except (ValueError, TypeError): pass
		return getsys_full(sys, time, site, bore=bore)
	(fs, from_ref) = parse(from_sys)
	(ts, to_ref) = parse(to_sys)
	cur = coords
	if from_ref is not None:
		cur = decenter(cur, from_ref[0], restore=from_ref[1])
	# walk to the target system through the hor chain
	if fs != ts:
		if fs == "bore":
			cur = bore2tele(cur, bore); fs = "tele"
		if fs == "tele" and ts not in ["bore"]:
			cur = tele2hor(cur, site); fs = "altaz"
		if fs == "altaz" and ts not in ["tele", "bore"]:
			cur = hor2cel(cur, time, site); fs = "equ"
		if fs in _MAT_SYS and ts in _MAT_SYS:
			cur = np.asarray(transform_simple(fs, ts, cur)); fs = ts
		elif fs in _MAT_SYS and ts not in _MAT_SYS:
			cur = np.asarray(transform_simple(fs, "equ", cur)); fs = "equ"
		if fs == "equ" and ts in ["altaz", "tele", "bore"]:
			cur = cel2hor(cur, time, site); fs = "altaz"
		if fs == "altaz" and ts in ["tele", "bore"]:
			cur = hor2tele(cur, site); fs = "tele"
		if fs == "tele" and ts == "bore":
			cur = tele2bore(cur, bore); fs = "bore"
	if to_ref is not None:
		cur = recenter(cur, to_ref[0], restore=to_ref[1])
	return cur

def transform_euler(euler, coords, pol=None, mag=None):
	"""Transform coords by zyz euler angles, with optional polarization
	angle and magnification rows (pixell_tpu.coordinates.transform_euler)."""
	coords = np.asarray(coords)
	def rotfun(c): return euler_rot(euler, c)
	meta = transform_meta(rotfun, coords[:2])
	nfield = max(0, len(coords) - 2)
	res = np.zeros((2 + nfield,) + np.shape(meta.ocoord)[1:])
	res[:2] = meta.ocoord
	if nfield >= 1:
		res[2] = coords[2] + meta.ang
	if nfield >= 2:
		res[3] = coords[3]
	return res

def transform_astropy(from_sys, to_sys, coords):
	"""The fixed-matrix systems, without astropy
	(pixell_tpu.coordinates.transform_astropy)."""
	return transform(from_sys, to_sys, coords)
