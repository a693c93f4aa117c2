"""Unified ephemeris interface (counterpart of pixell_tpu/ephem.py).

Module-level eval / add / bodies and the Ephem class family (AstropyEphem,
PyephemEphem, PrecompEphem, InterpEphem, MultiEphem, KeplerEphem). Every
eval(name, ctime, cartesian=False, site=None) returns (pos[..., {ra, dec}]
radians, dist[...] AU), or rect[..., 3] AU with cartesian=True; ctime is
unix time. A backend implements one method, _rect(name, ctime, site) ->
rect[..., 3] (observer-relative equatorial cartesian, AU); the base class
normalizes names and gives the output conventions. AstropyEphem and
PyephemEphem import their packages when made (ImportError without them);
the default is then KeplerEphem, the JPL approximate mean Keplerian
elements (1800-2050, arcminute level) with a low-precision Moon, behind
InterpEphem. Host numpy throughout: an ephemeris is a few positions a
call, and coordinates.py takes them on the host too.
"""
from __future__ import annotations
import os, glob
import numpy as np
from . import utils, sites


def _ang2rect(pos):
	"""[..., {ra,dec}] -> unit vectors [..., 3]."""
	ra, dec = pos[..., 0], pos[..., 1]
	cd = np.cos(dec)
	return np.stack([cd*np.cos(ra), cd*np.sin(ra), np.sin(dec)], -1)

def _rect2ang_r(rect):
	"""[..., 3] -> ([..., {ra,dec}], r)."""
	x, y, z = rect[..., 0], rect[..., 1], rect[..., 2]
	r = np.sqrt(x*x + y*y + z*z)
	ra = np.mod(np.arctan2(y, x), 2*np.pi)
	dec = np.arcsin(np.clip(z/np.maximum(r, 1e-300), -1, 1))
	return np.stack([ra, dec], -1), r


class Ephem:
	"""Base class. Subclasses provide _rect(name, ctime, site); the output
	conventions live here, once."""
	def __init__(self, bodies=(), capitalize=True):
		self.bodies = list(bodies)
		self.capitalize = capitalize
	def _norm(self, name):
		return name.capitalize() if self.capitalize else name
	def _rect(self, name, ctime, site):
		raise NotImplementedError
	def eval(self, name, ctime, cartesian=False, site=None):
		ctime = np.asarray(ctime, float)
		rect = self._rect(self._norm(name), ctime, site)
		return rect if cartesian else _rect2ang_r(rect)


class MultiEphem(Ephem):
	"""Dispatches each body to the provider that knows it; when several do,
	the most recently added wins (pixell's MultiEphem semantics)."""
	def __init__(self, others=(), capitalize=True):
		super().__init__(capitalize=capitalize)
		self._provider = {}
		for other in others:
			self.add(other)
	def add(self, other):
		for body in other.bodies:
			self._provider[body] = other
		self.bodies = list(self._provider)
	def eval(self, name, ctime, cartesian=False, site=None):
		key = self._norm(name)
		try:
			prov = self._provider[key]
		except KeyError:
			raise KeyError("No ephemeris found for '%s'" % str(name))
		return prov.eval(key, ctime, cartesian=cartesian, site=site)


class AstropyEphem(Ephem):
	"""Backend over astropy's solar_system_ephemeris (pixell's
	AstropyEphem:73). Slow; wrap in InterpEphem. Requires astropy."""
	def __init__(self, ephemeris="builtin", site=None, capitalize=True):
		import astropy.coordinates as aco
		super().__init__(
			bodies=[b.capitalize() for b in aco.solar_system_ephemeris.bodies],
			capitalize=capitalize)
		self.ephemeris = ephemeris
		self.site = site
	def _rect(self, name, ctime, site):
		import astropy.time as ati
		import astropy.coordinates as aco
		site = site or self.site or sites.default_site
		loc = aco.EarthLocation.from_geodetic(site.lon, site.lat, site.alt)
		body = aco.get_body(name, ati.Time(ctime, format="unix"),
			location=loc, ephemeris=self.ephemeris)
		c = body.cartesian
		return np.stack([q.to("AU").value for q in (c.x, c.y, c.z)], -1)


class PyephemEphem(Ephem):
	"""Backend over pyephem (pixell's PyephemEphem). Requires ephem."""
	BODIES = ("Ariel Callisto Deimos Dione Enceladus Europa Ganymede Hyperion "
		"Iapetus Io Jupiter Mars Mercury Mimas Miranda Moon Neptune Oberon "
		"Phobos Pluto Rhea Saturn Sun Tethys Titan Titania Umbriel Uranus "
		"Venus").split()
	def __init__(self, site=None, capitalize=True):
		import ephem  # noqa: F401 -- availability check
		super().__init__(bodies=self.BODIES, capitalize=capitalize)
		self.site = site
	def _rect(self, name, ctime, site):
		import ephem
		site = site or self.site or sites.default_site
		observer = ephem.Observer()
		observer.lon, observer.lat = site.lon, site.lat
		observer.elevation = site.alt
		body = getattr(ephem, name)()
		def one(djd):
			observer.date = djd
			body.compute(observer)
			return (float(body.a_ra), float(body.a_dec),
				float(body.earth_distance))
		samples = np.array([one(d) for d in
			np.ravel(utils.ctime2djd(ctime))])
		ang = samples[:, :2].reshape(ctime.shape + (2,))
		r = samples[:, 2].reshape(ctime.shape)
		return _ang2rect(ang)*r[..., None]


class PrecompEphem(Ephem):
	"""Backend reading precomputed <path>/<Name>.npy structured arrays with
	"ctime" and "pos" ([n, 3] cartesian AU) fields (pixell's
	PrecompEphem:157). Site was baked into the precomputation."""
	def __init__(self, path, capitalize=True):
		names = sorted(glob.glob(os.path.join(path, "*.npy")))
		super().__init__(bodies=[os.path.basename(f)[:-4] for f in names],
			capitalize=capitalize)
		self.path = path
		self._splines = {}
	def _rect(self, name, ctime, site):
		if name not in self._splines:
			from scipy.interpolate import CubicSpline
			tab = np.load(os.path.join(self.path, name + ".npy"))
			self._splines[name] = CubicSpline(tab["ctime"], tab["pos"], axis=0)
		return self._splines[name](ctime)
	def clear(self):
		self._splines = {}


class InterpEphem(Ephem):
	"""Accelerator: evaluates a slow backend on a coarse time grid and
	cubic-splines to the requested times (pixell's InterpEphem,
	~1000x for astropy/pyephem). dt is the knot spacing in seconds; the
	default 300 s keeps spline error far below the backends' accuracy."""
	def __init__(self, other, dt=300):
		super().__init__(bodies=other.bodies, capitalize=other.capitalize)
		self.other = other
		self.dt = dt
	def _rect(self, name, ctime, site):
		flat = np.ravel(ctime)
		if flat.size == 0:
			return np.zeros(ctime.shape + (3,))
		t0, t1 = float(flat.min()), float(flat.max())
		nknot = max(int(np.ceil((t1 - t0)/self.dt)) + 1, 4)
		if flat.size <= nknot:
			# fewer queries than knots: interpolation can't win
			return self.other.eval(name, ctime, cartesian=True, site=site)
		from scipy.interpolate import CubicSpline
		knots = np.linspace(t0, t1, nknot)
		base = self.other.eval(name, knots, cartesian=True, site=site)
		return CubicSpline(knots, base, axis=0)(flat) \
			.reshape(ctime.shape + (3,))


# ---------------------------------------------------------------------------
# Dependency-free analytic backend (default when pyephem/astropy are absent)
# ---------------------------------------------------------------------------

# JPL approximate mean Keplerian elements (J2000 ecliptic), valid 1800-2050:
# a [AU], e, I [deg], L [deg], long.peri [deg], long.node [deg] and their
# per-Julian-century rates.
_ELEMENTS = {
	"Mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
		(0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081)),
	"Venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
		(0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418)),
	"Earth": ((1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
		(0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0)),
	"Mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
		(0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343)),
	"Jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
		(-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106)),
	"Saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
		(-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794)),
	"Uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
		(-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589)),
	"Neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
		(0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664)),
	"Pluto": ((39.48211675, 0.24882730, 17.14001206, 238.92903833, 224.06891629, 110.30393684),
		(-0.00031596, 0.00005170, 0.00004818, 145.20780515, -0.04062942, -0.01183482)),
}
_OBLIQUITY = np.deg2rad(23.43928)


def _kepler(M, e, niter=8):
	"""Solve Kepler's equation E - e sin E = M by Newton iteration."""
	E = M + e*np.sin(M)
	for _ in range(niter):
		E = E - (E - e*np.sin(E) - M)/(1 - e*np.cos(E))
	return E


def _helio_ecl(name, T):
	"""Heliocentric ecliptic rectangular coords [..., 3] in AU at Julian
	centuries-from-J2000 T, from the mean-element tables."""
	el0, rates = _ELEMENTS[name]
	a, e, I, L, lperi, lnode = [e0 + d*T for e0, d in zip(el0, rates)]
	I, L, lperi, lnode = [np.deg2rad(x) for x in (I, L, lperi, lnode)]
	w = lperi - lnode           # argument of perihelion
	M = np.mod(L - lperi + np.pi, 2*np.pi) - np.pi
	E = _kepler(M, e)
	# position in orbital plane
	xp = a*(np.cos(E) - e)
	yp = a*np.sqrt(1 - e*e)*np.sin(E)
	cw, sw = np.cos(w), np.sin(w)
	cO, sO = np.cos(lnode), np.sin(lnode)
	cI, sI = np.cos(I), np.sin(I)
	x = (cw*cO - sw*sO*cI)*xp + (-sw*cO - cw*sO*cI)*yp
	y = (cw*sO + sw*cO*cI)*xp + (-sw*sO + cw*cO*cI)*yp
	z = (sw*sI)*xp + (cw*sI)*yp
	return np.stack([x, y, z], -1)


def _ecl2equ(r):
	"""Rotate ecliptic rectangular coords to equatorial."""
	ce, se = np.cos(_OBLIQUITY), np.sin(_OBLIQUITY)
	x, y, z = r[..., 0], r[..., 1], r[..., 2]
	return np.stack([x, ce*y - se*z, se*y + ce*z], -1)


def _moon_rect(T):
	"""Geocentric equatorial rect coords of the Moon in AU (low-precision
	lunar theory, ~0.3 deg)."""
	d = T*36525.0
	L = np.deg2rad((218.316 + 13.176396*d) % 360)
	M = np.deg2rad((134.963 + 13.064993*d) % 360)
	F = np.deg2rad((93.272 + 13.229350*d) % 360)
	lam  = L + np.deg2rad(6.289)*np.sin(M)
	beta = np.deg2rad(5.128)*np.sin(F)
	dist = (385001 - 20905*np.cos(M))*1e3/utils.AU
	cb = np.cos(beta)
	ecl = np.stack([dist*cb*np.cos(lam), dist*cb*np.sin(lam),
		dist*np.sin(beta)], -1)
	return _ecl2equ(ecl)


class KeplerEphem(Ephem):
	"""Analytic geocentric ephemeris from JPL mean Keplerian elements
	(planets, arcmin-level 1800-2050) plus low-precision Sun/Moon. Purely
	numpy; ignores the site (topocentric parallax is below its accuracy
	for everything but the Moon)."""
	def __init__(self, capitalize=True):
		super().__init__(
			bodies=[n for n in _ELEMENTS if n != "Earth"] + ["Sun", "Moon"],
			capitalize=capitalize)
	def _rect(self, name, ctime, site):
		T = (ctime/86400.0 + 40587.0 - 51544.5)/36525.0  # centuries from J2000
		earth = _ecl2equ(_helio_ecl("Earth", T))
		if name == "Sun":
			return -earth
		if name == "Moon":
			return _moon_rect(T)
		if name in _ELEMENTS:
			return _ecl2equ(_helio_ecl(name, T)) - earth
		raise KeyError("KeplerEphem has no body '%s'" % name)


def _make_default():
	try:
		return MultiEphem([InterpEphem(PyephemEphem())])
	except ImportError:
		return MultiEphem([InterpEphem(KeplerEphem())])

# Default ephemeris (pixell_tpu/ephem.py:237)
default_ephem = _make_default()

def eval(name, ctime, cartesian=False, site=None):
	return default_ephem.eval(name, ctime, cartesian=cartesian, site=site)

def add(ephem):
	default_ephem.add(ephem)

bodies = default_ephem.bodies


# ---------------------------------------------------------------------------
# mjd-based convenience wrappers used by coordinates.py (pixell's
# coordinates.ephem_pos:387 / interpol_pos:406 work in mjd).
# ---------------------------------------------------------------------------
def ephem_pos(name, mjd, ephem=None):
	"""Equatorial position [{ra,dec}] (radians) of the named object at mjd."""
	ctime = (np.asarray(mjd, float) - 40587.0)*86400.0
	eph = ephem or default_ephem
	pos, r = eph.eval(name, ctime)
	return np.moveaxis(pos, -1, 0)

class EphemPrecomputed(Ephem):
	"""Tabulated [{ra,dec}] positions with interpolation (mjd-based legacy
	helper kept for coordinates.interpol_pos)."""
	def __init__(self, mjds, poss):
		super().__init__(bodies=[])
		self.mjds = np.asarray(mjds)
		self.poss = np.asarray(poss)  # [{ra,dec}, n]
	def pos(self, name, mjd):
		ra  = np.interp(mjd, self.mjds, np.unwrap(self.poss[0]))
		dec = np.interp(mjd, self.mjds, self.poss[1])
		return np.stack([np.asarray(ra) % (2*np.pi), np.asarray(dec)])
	def _rect(self, name, ctime, site):
		mjd = ctime/86400.0 + 40587.0
		return _ang2rect(np.moveaxis(self.pos(name, mjd), 0, -1))

def interpol_pos(name, mjd1, mjd2, n=100, ephem=None):
	"""Precompute positions over an mjd range for fast interpolation."""
	mjds = np.linspace(mjd1, mjd2, n)
	poss = ephem_pos(name, mjds, ephem=ephem)
	return EphemPrecomputed(mjds, poss)
