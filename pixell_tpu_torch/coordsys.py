"""Plain coordinate transformations through an atom graph (counterpart of
pixell_tpu/coordsys.py): Coords objects holding lon/lat/psi or a rotation,
atoms with a shortest-path search between base systems (hor, equ, gal,
sidelobe), and the lon/lat and xi/eta (de)compositions. Rotations are
[..., 3, 3] matrices, as in the reference (pixell's quaternions are not
available). Host numpy throughout: the atoms call coordinates.py's host
transforms.
"""
import numpy as np
from . import bunch, sites, utils
from . import coordinates as _coords

DEG = np.pi/180

sys_map = {"hor": "hor", "equ": "equ", "cel": "equ", "gal": "gal",
	"sidelobe": "sidelobe"}


def asfarray(arr, default_dtype=np.float64):
	return np.asarray(arr, default_dtype)

def maybearr(a, default_dtype=np.float64):
	return None if a is None else np.asarray(a, default_dtype)

def left_handed(sys): return sys in ["hor"]
def space_sys(sys): return sys not in ["hor"]
def el_in_range(el): return np.all((np.asarray(el) >= -np.pi/2) & (np.asarray(el) <= np.pi/2))


# --- rotation helpers (pixell_tpu.coordsys.euler/rotation_*: quaternions
# there, matrices here; "q" below is a [...,3,3] rotation matrix) ---
def euler(axis, angle):
	"""Rotation matrix about coordinate axis index 0/1/2
	(pixell_tpu.coordsys.euler)."""
	return utils.rotmatrix(np.asarray(angle), "xyz"[axis])

def trivial_quat(q):
	if q is None: return True
	q = np.asarray(q)
	return q.shape[-2:] == (3, 3) and np.allclose(q, np.eye(3))

def rotation_lonlat(lon, lat, psi=0):
	"""Rotation taking the z axis to (lon, lat) with roll psi
	(pixell_tpu.coordsys.rotation_lonlat)."""
	return (utils.rotmatrix(np.asarray(lon), "z")
		@ utils.rotmatrix(np.pi/2 - np.asarray(lat), "y")
		@ utils.rotmatrix(np.asarray(psi), "z"))

def decompose_lonlat(q):
	"""(lon, lat, psi) of a rotation built by rotation_lonlat
	(pixell_tpu.coordsys.decompose_lonlat)."""
	q = np.asarray(q)
	z = q[..., :, 2]              # image of the z axis
	lat = np.arcsin(np.clip(z[..., 2], -1, 1))
	lon = np.arctan2(z[..., 1], z[..., 0])
	# undo lon/lat rotation to read off psi
	undo = np.swapaxes(rotation_lonlat(lon, lat, 0), -1, -2)
	rest = undo @ q
	psi = np.arctan2(rest[..., 1, 0], rest[..., 0, 0])
	return lon, lat, psi

def rotation_xieta(xi, eta, gamma=0):
	"""Rotation for the xi-eta tangent-plane convention
	(pixell_tpu.coordsys.rotation_xieta): xi = -sin(lon) cos(lat), eta = sin(lat)."""
	xi = np.asarray(xi); eta = np.asarray(eta)
	lat = np.arcsin(np.clip(eta, -1, 1))
	lon = np.arcsin(np.clip(-xi/np.maximum(np.cos(lat), 1e-300), -1, 1))
	return rotation_lonlat(lon, lat, gamma)

def decompose_xieta(q):
	lon, lat, psi = decompose_lonlat(q)
	xi = -np.sin(lon)*np.cos(lat)
	eta = np.sin(lat)
	return xi, eta, psi


# --- base transforms (pixell_tpu.coordsys.hor2equ etc) ---
def hor2equ(coords, ctime, site=None, weather=None, **kwargs):
	"""[{az,el},...] -> [{ra,dec},...] (pixell_tpu.coordsys.hor2equ;
	sidereal approximation, no refraction)."""
	if site is None: site = _coords.default_site
	mjd = np.asarray(ctime)/86400.0 + 40587.0
	c = np.asarray(coords)
	res = _coords.hor2equ(np.array([-c[0], c[1]]) if False else c[:2], mjd, site)
	out = np.array(c, copy=True)
	out[:2] = res
	return out

def equ2hor(coords, ctime, site=None, weather=None, **kwargs):
	if site is None: site = _coords.default_site
	mjd = np.asarray(ctime)/86400.0 + 40587.0
	c = np.asarray(coords)
	res = _coords.equ2hor(c[:2], mjd, site)
	out = np.array(c, copy=True)
	out[:2] = res
	return out

def equ2gal(coords, *args, **kwargs):
	c = np.asarray(coords)
	out = np.array(c, copy=True)
	out[:2] = _coords.transform("equ", "gal", c[:2])
	return out

def gal2equ(coords, *args, **kwargs):
	c = np.asarray(coords)
	out = np.array(c, copy=True)
	out[:2] = _coords.transform("gal", "equ", c[:2])
	return out

def hor2sidelobe(coords, bore, **kwargs):
	"""To boresight(sidelobe)-relative coordinates
	(pixell_tpu.coordsys.hor2sidelobe)."""
	c = np.asarray(coords)
	out = np.array(c, copy=True)
	out[:2] = _coords.recenter(c[:2], np.asarray(bore)[:2])
	return out

def sidelobe2hor(coords, bore, **kwargs):
	c = np.asarray(coords)
	out = np.array(c, copy=True)
	out[:2] = _coords.decenter(c[:2], np.asarray(bore)[:2])
	return out


# --- atom graph (pixell_tpu.coordsys.Atom/find_path) ---
class Atom:
	def __init__(self, ibase, obase):
		self.ibase, self.obase = ibase, obase
	def apply(self, coords, **kwargs):
		raise NotImplementedError

class AtomQuat(Atom):
	def __init__(self, ibase, obase, q):
		Atom.__init__(self, ibase, obase)
		self.q = np.asarray(q)
	def apply(self, coords, **kwargs):
		rect = utils.ang2rect(np.asarray(coords)[:2], axis=0)
		rect = np.tensordot(self.q, rect.reshape(3, -1), 1).reshape(rect.shape)
		out = np.array(coords, copy=True)
		out[:2] = utils.rect2ang(rect, axis=0)
		return out

class AtomFun(Atom):
	def __init__(self, ibase, obase, fun, needs=[]):
		Atom.__init__(self, ibase, obase)
		self.fun = fun
		self.needs = needs
	def apply(self, coords, **kwargs):
		args = {}
		for need in self.needs:
			args[need] = kwargs.get(need)
		if "ctime" in self.needs:
			return self.fun(coords, kwargs.get("ctime"),
				site=kwargs.get("site"), weather=kwargs.get("weather"))
		if "bore" in self.needs:
			return self.fun(coords, kwargs.get("bore"))
		return self.fun(coords)

atoms = [
	AtomFun("hor", "equ", hor2equ, needs=["ctime", "site", "weather"]),
	AtomFun("equ", "hor", equ2hor, needs=["ctime", "site", "weather"]),
	AtomFun("equ", "gal", equ2gal),
	AtomFun("gal", "equ", gal2equ),
	AtomFun("hor", "sidelobe", hor2sidelobe, needs=["bore"]),
	AtomFun("sidelobe", "hor", sidelobe2hor, needs=["bore"]),
]

def find_path(atoms_, ibase, obase):
	"""Shortest atom path from ibase to obase
	(pixell_tpu.coordsys.find_path)."""
	if ibase == obase: return []
	best = None
	for path in _find_path_helper(atoms_, ibase, obase):
		if best is None or len(path) < len(best):
			best = path
	if best is None:
		raise ValueError("No path from '%s' to '%s'" % (ibase, obase))
	return list(best)

def _find_path_helper(atoms_, ibase, obase, seen=[]):
	if ibase == obase:
		yield ()
	else:
		seen = seen + [ibase]
		for atom in atoms_:
			if atom.ibase != ibase: continue
			if atom.obase in seen: continue
			for path in _find_path_helper(atoms_, atom.obase, obase, seen=seen):
				yield (atom,) + path


class Coords:
	"""az/el/roll <-> ra/dec/psi <-> rotation form container
	(pixell_tpu.coordsys.Coords); the rotation form is a [...,3,3] matrix here."""
	def __init__(self, az=None, el=None, roll=None, ra=None, dec=None,
			psi=None, q=None, iq=None):
		self._lon = maybearr(ra)
		if az is not None: self._lon = -asfarray(az)
		self._lat = maybearr(dec)
		if el is not None: self._lat = asfarray(el)
		self._psi = maybearr(psi)
		if roll is not None: self._psi = asfarray(roll)
		self._q = None if q is None else np.asarray(q)
		self._iq = None if iq is None else np.asarray(iq)
		if self._psi is None and self._q is None and self._lon is not None:
			self._psi = np.zeros_like(self._lon)
	@property
	def lon(self):
		if self._lon is None: self._from_q()
		return self._lon
	ra = phi = lon
	@property
	def lat(self):
		if self._lat is None: self._from_q()
		return self._lat
	dec = el = lat
	@property
	def az(self): return -self.lon
	@property
	def theta(self): return np.pi/2 - self.lat
	@property
	def psi(self):
		if self._psi is None: self._from_q()
		return self._psi
	roll = psi
	@property
	def q(self):
		if self._q is None:
			self._q = rotation_lonlat(self._lon, self._lat, self._psi)
		return self._q
	@property
	def iq(self):
		if self._iq is None:
			self._iq = np.swapaxes(self.q, -1, -2)
		return self._iq
	@property
	def has_coords(self): return self._lon is not None
	@property
	def has_q(self): return self._q is not None
	@property
	def has_iq(self): return self._iq is not None
	@property
	def shape(self):
		if self.has_iq: return self._iq.shape[:-2]
		if self.has_q:  return self._q.shape[:-2]
		return np.shape(self._lon)
	def copy(self):
		import copy as _copy
		return _copy.deepcopy(self)
	def _from_q(self):
		lon, lat, psi = decompose_lonlat(self._q)
		self._lon, self._lat, self._psi = lon, lat, psi
	def __mul__(self, other):
		oq = other.q if isinstance(other, Coords) else np.asarray(other)
		return Coords(q=self.q @ oq)
	def __repr__(self):
		return "Coords(lon=%s, lat=%s, psi=%s)" % (
			str(self.lon), str(self.lat), str(self.psi))


def expand_sys(sys, ctime=None, site=None, weather=None, bore=None):
	"""Parse a system spec into bunch(base, q)
	(pixell_tpu.coordsys.expand_sys)."""
	if isinstance(sys, str):
		base, q = parse_sys(sys)
	elif isinstance(sys, (tuple, list)) and isinstance(sys[0], str):
		base, q = sys[0], (sys[1] if len(sys) > 1 else None)
	else:
		base, q = sys, None
	base = sys_map.get(base, base)
	return bunch.Bunch(base=base, q=q)

def parse_sys(desc):
	"""Parse 'sys[:lon_lat[_psi]]' descriptions
	(pixell_tpu.coordsys.parse_sys). Returns (base, q or None)."""
	toks = str(desc).split(":")
	base = toks[0].lower()
	if len(toks) == 1: return base, None
	vals = [float(v)*DEG for v in toks[1].split("_")]
	lon, lat = vals[0], vals[1]
	psi = vals[2] if len(vals) > 2 else 0.0
	return base, rotation_lonlat(lon, lat, psi)

def transform(isys, osys, coords, ctime=None, site=None, weather=None, bore=None):
	"""Transform coords[2 or 3,...] between systems through the atom graph
	(pixell_tpu.coordsys.transform)."""
	if isys == osys: return coords
	if site is None: site = sites.get("act") if hasattr(sites, "get") else None
	isys = expand_sys(isys, ctime=ctime, site=site, weather=weather, bore=bore)
	osys = expand_sys(osys, ctime=ctime, site=site, weather=weather, bore=bore)
	coords = np.asarray(coords, float)
	if not trivial_quat(isys.q):
		rect = utils.ang2rect(coords[:2], axis=0)
		rect = np.tensordot(np.swapaxes(isys.q, -1, -2), rect.reshape(3, -1), 1).reshape(rect.shape)
		coords = np.concatenate([utils.rect2ang(rect, axis=0), coords[2:]], 0)
	for atom in find_path(atoms, isys.base, osys.base):
		coords = atom.apply(coords, ctime=ctime, site=site, weather=weather, bore=bore)
	if not trivial_quat(osys.q):
		rect = utils.ang2rect(np.asarray(coords)[:2], axis=0)
		rect = np.tensordot(osys.q, rect.reshape(3, -1), 1).reshape(rect.shape)
		coords = np.concatenate([utils.rect2ang(rect, axis=0), np.asarray(coords)[2:]], 0)
	return coords
