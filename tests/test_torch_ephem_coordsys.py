"""pixell_tpu_torch.ephem, .coordsys and coordinates' ephemeris objects
against pixell_tpu's on the CPU (host numpy, float64, inputs from a numpy
seed), within 1e-12 rad (and 1e-12 AU relative for distances):

- KeplerEphem for every body it knows, angles and distances and the
  cartesian form; PrecompEphem on tables written to tmp_path; InterpEphem
  over KeplerEphem (many times: the spline; fewer than its knots: the
  direct call; none); MultiEphem's dispatch, add and KeyError; the module's
  eval / add / bodies; AstropyEphem and PyephemEphem raise ImportError
  without their packages, as the reference's do; ephem_pos / interpol_pos /
  EphemPrecomputed;
- coordinates' ephem_pos and interpol_pos (a body and a fixed point) and
  the centre given by a body's name ("equ:Jupiter", "equ:Sun/Jupiter") in
  transform;
- coordsys: transform between every pair of base systems (hor, equ, gal,
  sidelobe, their aliases) with ctime, site and bore, recentered and
  rotated specs ("equ:10_20", "gal:30_-10_15", tuples), a third (angle) row
  carried; the rotation helpers (euler, rotation_lonlat /
  decompose_lonlat, rotation_xieta / decompose_xieta, trivial_quat), the
  atoms, find_path, expand_sys, parse_sys, the Coords container, and
  every public name of the reference's module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import ephem as jephem, coordsys as jcoordsys, coordinates as jcoordinates, utils as jutils
from pixell_tpu_torch import ephem, coordsys, coordinates

TOL = 1e-12
CTIME = 1.6e9 + np.linspace(0, 3e6, 40)


def angerr(a, b):
	"""Largest difference of [{ra, dec}, ...] angle pairs (any axis 0 of
	size 2, or [..., {ra, dec}]), the ra difference wrapped and scaled by
	cos(dec)."""
	a, b = np.asarray(a, float), np.asarray(b, float)
	assert a.shape == b.shape
	if a.shape[0] != 2: a, b = np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0)
	d0 = jutils.rewind(a[0] - b[0])*np.cos(b[1])
	return float(max(np.max(np.abs(d0)), np.max(np.abs(a[1] - b[1])), *(np.max(np.abs(a[i] - b[i]))
		for i in range(2, len(a)))))


@pytest.mark.parametrize("body", ["Mercury", "venus", "Mars", "Jupiter", "Saturn", "Uranus", "Neptune", "Pluto",
	"Sun", "Moon"])
def test_kepler(body):
	je, te = jephem.KeplerEphem(), ephem.KeplerEphem()
	assert te.bodies == je.bodies
	(jp, jr), (tp, tr) = je.eval(body, CTIME), te.eval(body, CTIME)
	assert angerr(tp, jp) <= TOL and np.max(np.abs(tr/jr - 1)) <= TOL
	assert np.max(np.abs(te.eval(body, CTIME[3], cartesian=True) - je.eval(body, CTIME[3], cartesian=True))) <= TOL
	with pytest.raises(KeyError):
		te.eval("Vulcan", CTIME)


def test_precomp(tmp_path):
	k = jephem.KeplerEphem()
	t = np.linspace(1.59e9, 1.61e9, 200)
	for name in ("Jupiter", "Mars"):
		tab = np.zeros(len(t), [("ctime", "f8"), ("pos", "f8", (3,))])
		tab["ctime"], tab["pos"] = t, k.eval(name, t, cartesian=True)
		np.save(tmp_path/(name + ".npy"), tab)
	je, te = jephem.PrecompEphem(str(tmp_path)), ephem.PrecompEphem(str(tmp_path))
	assert te.bodies == je.bodies == ["Jupiter", "Mars"]
	for name in ("jupiter", "Mars"):
		(jp, jr), (tp, tr) = je.eval(name, CTIME), te.eval(name, CTIME)
		assert angerr(tp, jp) <= TOL and np.max(np.abs(tr/jr - 1)) <= TOL
	te.clear()
	assert te._splines == {}


def test_interp_multi():
	je, te = jephem.InterpEphem(jephem.KeplerEphem(), dt=3600), ephem.InterpEphem(ephem.KeplerEphem(), dt=3600)
	for t in (CTIME, 1.6e9 + np.linspace(0, 3e5, 500), np.array([1.6e9])):
		(jp, jr), (tp, tr) = je.eval("Moon", t), te.eval("Moon", t)
		assert angerr(tp, jp) <= TOL and np.max(np.abs(tr/jr - 1)) <= TOL
	assert te.eval("Sun", np.zeros(0), cartesian=True).shape == (0, 3)
	jm, tm = jephem.MultiEphem([jephem.KeplerEphem()]), ephem.MultiEphem([ephem.KeplerEphem()])
	assert tm.bodies == jm.bodies
	assert angerr(tm.eval("sun", CTIME)[0], jm.eval("sun", CTIME)[0]) <= TOL
	with pytest.raises(KeyError):
		tm.eval("Vulcan", CTIME)
	assert angerr(ephem.eval("Mars", CTIME)[0], jephem.eval("Mars", CTIME)[0]) <= TOL
	assert ephem.bodies == jephem.bodies
	extra = ephem.MultiEphem()
	extra.add(ephem.KeplerEphem())
	assert extra.bodies == tm.bodies
	for cls in ("AstropyEphem", "PyephemEphem"):
		for mod in (jephem, ephem):
			with pytest.raises(ImportError):
				getattr(mod, cls)()


def test_ephem_pos():
	mjd = 59000 + np.linspace(0, 30, 11)
	assert angerr(ephem.ephem_pos("Jupiter", mjd), jephem.ephem_pos("Jupiter", mjd)) <= TOL
	tp, jp = ephem.interpol_pos("Moon", 59000, 59001, n=20), jephem.interpol_pos("Moon", 59000, 59001, n=20)
	assert angerr(tp.pos("Moon", mjd[:3]/30 + 59000), jp.pos("Moon", mjd[:3]/30 + 59000)) <= TOL
	assert np.max(np.abs(tp._rect("Moon", np.array([1.59e9]), None) - jp._rect("Moon", np.array([1.59e9]), None))) \
		<= TOL


def test_coordinates_ephemeris():
	rng = np.random.default_rng(3)
	c = np.array([rng.uniform(0, 2*np.pi, 30), np.arcsin(rng.uniform(-1, 1, 30))])
	mjd = 58000 + np.linspace(0, 0.2, 9)
	assert angerr(coordinates.ephem_pos("Saturn", mjd), jcoordinates.ephem_pos("Saturn", mjd)) <= TOL
	for name_or_pos in ("Moon", np.array([1.0, 0.3])):
		got = coordinates.interpol_pos("equ", "gal", name_or_pos, mjd)
		assert angerr(got, jcoordinates.interpol_pos("equ", "gal", name_or_pos, mjd)) <= TOL
	for sys in ("equ:Jupiter", "gal:Moon", "equ:Sun/Jupiter"):
		assert angerr(coordinates.transform("equ", sys, c, time=58001.3),
			jcoordinates.transform("equ", sys, c, time=58001.3)) <= TOL
		assert angerr(coordinates.transform(sys, "gal", c, time=58001.3),
			jcoordinates.transform(sys, "gal", c, time=58001.3)) <= TOL


SYSTEMS = ["hor", "equ", "cel", "gal", "sidelobe", "equ:10_20", "gal:30_-10_15", ("equ", None)]


@pytest.mark.parametrize("isys", SYSTEMS)
def test_coordsys_transform(isys):
	rng = np.random.default_rng(4)
	n = 25
	coords = np.array([rng.uniform(0, 2*np.pi, n), np.arcsin(rng.uniform(-0.95, 0.95, n)), rng.uniform(-1, 1, n)])
	ctime = 1.6e9 + rng.uniform(0, 1e5, n)
	bore = np.array([0.3, 0.9])
	for osys in SYSTEMS:
		kw = dict(ctime=ctime, bore=bore)
		want = jcoordsys.transform(isys, osys, coords, **kw)
		got = coordsys.transform(isys, osys, coords, **kw)
		assert angerr(got, want) <= TOL, (isys, osys)


def test_coordsys_helpers():
	rng = np.random.default_rng(5)
	lon, lat, psi = rng.uniform(-3, 3, 8), rng.uniform(-1.4, 1.4, 8), rng.uniform(-3, 3, 8)
	q = coordsys.rotation_lonlat(lon, lat, psi)
	assert np.max(np.abs(q - jcoordsys.rotation_lonlat(lon, lat, psi))) <= TOL
	for a, b in zip(coordsys.decompose_lonlat(q), jcoordsys.decompose_lonlat(q)):
		assert np.max(np.abs(a - b)) <= TOL
	xi, eta = rng.uniform(-0.5, 0.5, 8), rng.uniform(-0.5, 0.5, 8)
	qx = coordsys.rotation_xieta(xi, eta, psi)
	assert np.max(np.abs(qx - jcoordsys.rotation_xieta(xi, eta, psi))) <= TOL
	for a, b in zip(coordsys.decompose_xieta(qx), jcoordsys.decompose_xieta(qx)):
		assert np.max(np.abs(a - b)) <= TOL
	for axis in range(3):
		assert np.max(np.abs(coordsys.euler(axis, psi) - jcoordsys.euler(axis, psi))) <= TOL
	assert coordsys.trivial_quat(None) and coordsys.trivial_quat(np.eye(3)) and not coordsys.trivial_quat(q[0])
	assert coordsys.left_handed("hor") and not coordsys.space_sys("hor") and coordsys.el_in_range(lat)
	assert coordsys.maybearr(None) is None and coordsys.asfarray([1, 2]).dtype == np.float64
	for sys in ("cel", "gal:10_20", ("equ", q[0]), "hor"):
		a, b = coordsys.expand_sys(sys), jcoordsys.expand_sys(sys)
		assert a.base == b.base and (a.q is None) == (b.q is None)
		if a.q is not None: assert np.max(np.abs(a.q - b.q)) <= TOL
	assert coordsys.parse_sys("gal")[1] is None
	path = [(a.ibase, a.obase) for a in coordsys.find_path(coordsys.atoms, "gal", "sidelobe")]
	assert path == [(a.ibase, a.obase) for a in jcoordsys.find_path(jcoordsys.atoms, "gal", "sidelobe")]
	assert coordsys.find_path(coordsys.atoms, "equ", "equ") == []
	with pytest.raises(ValueError):
		coordsys.find_path(coordsys.atoms, "equ", "moon")
	c = np.array([rng.uniform(0, 6, 5), rng.uniform(-1, 1, 5)])
	quat = coordsys.AtomQuat("equ", "gal", q[0])
	assert angerr(quat.apply(c), jcoordsys.AtomQuat("equ", "gal", q[0]).apply(c)) <= TOL


def test_coords_container():
	rng = np.random.default_rng(6)
	az, el, roll = rng.uniform(0, 6, 4), rng.uniform(0.2, 1.2, 4), rng.uniform(-1, 1, 4)
	for kw in (dict(az=az, el=el, roll=roll), dict(ra=az, dec=el), dict(ra=az, dec=el, psi=roll)):
		a, b = coordsys.Coords(**kw), jcoordsys.Coords(**kw)
		for attr in ("lon", "lat", "psi", "az", "theta", "q", "iq", "shape"):
			assert np.max(np.abs(np.asarray(getattr(a, attr)) - np.asarray(getattr(b, attr)))) <= TOL, attr
		assert a.has_coords and a.has_q and a.has_iq
		p, r = a*a, b*b
		assert np.max(np.abs(p.q - r.q)) <= TOL
		for attr in ("lon", "lat", "psi"):
			assert np.max(np.abs(getattr(p, attr) - getattr(r, attr))) <= TOL
		assert a.copy().shape == a.shape and repr(a).startswith("Coords(")


def test_public_names():
	for ref, port in ((jephem, ephem), (jcoordsys, coordsys)):
		names = [n for n in dir(ref) if not n.startswith("_") and n not in ("annotations",)]
		assert [n for n in names if not hasattr(port, n)] == []
	assert len([n for n in dir(jcoordsys) if not n.startswith("_") and callable(getattr(jcoordsys, n))
		and getattr(getattr(jcoordsys, n), "__module__", "") == jcoordsys.__name__]) >= 25
