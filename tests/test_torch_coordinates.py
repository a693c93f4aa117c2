"""pixell_tpu_torch.coordinates and .sites against pixell_tpu's (host
numpy, no JAX program to compile), with positions from a numpy seed:

- transform between equ / gal / ecl (and their aliases), plain, with
  pol=True, with mag=True and with both, and with recentered specs (a
  4-component [center, restore] pair as thumbnails use, the string syntax
  "base:ra_dec[:refsys]", restore=True) within 1e-12 rad of the reference;
  the site-relative chain (hor, tele, bore) and transform_euler too;
- the device tensor path (CPU tensors) against the host path within
  1e-12, pol and mag included, and a system outside it (hor) through the
  host, returned as a tensor. The polarization angle row is held within
  DEV_ANG_TOL/cos(dec) there: it comes from positions an ra offset of
  5e-7 rad apart (transform_meta's finite offset), 5e-7 cos(dec) on the
  sky, so the last-bit difference between torch's and numpy's
  trigonometry reaches it divided by that (~1e-16/5e-7 ~ 2e-10 at the
  equator);
- recenter / decenter, euler_rot, the site and weather lookups;
- the ephemeris-object systems (ephem_pos, interpol_pos, a centre given by
  a body's name, on host arrays and on a tensor) against the reference's,
  within 1e-12 rad.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import coordinates as jcoordinates, sites as jsites, utils as jutils
from pixell_tpu_torch import coordinates, sites

TOL = 1e-12
DEV_ANG_TOL = 1e-8   # the device path's pol angle row against the host's, times cos(dec)


def angerr(got, want, cosdec=None):
	"""Largest difference in radians, the first row (ra) modulo 2 pi and
	times cos(dec) (ra's scale on the sky); the angle row (pol) modulo 2 pi
	as well. With cosdec, the input points' cos(dec), the angle row is held
	here to DEV_ANG_TOL/cosdec and left out of the result."""
	got, want = np.asarray(got, float), np.asarray(want, float)
	assert got.shape == want.shape
	d = got - want
	d[0] = jutils.rewind(d[0])*np.cos(want[1])
	if len(d) > 2: d[2] = jutils.rewind(d[2])
	if cosdec is not None and len(d) > 2:
		assert (np.abs(d[2])*cosdec).max() <= DEV_ANG_TOL
		d[2] = 0
	return np.abs(d).max()


def points(seed, n=300):
	"""[{ra, dec}, n], with the poles and the ra seam among them."""
	rng = np.random.default_rng(seed)
	ra = np.concatenate([[0.0, np.pi, 2*np.pi - 1e-9, 1.0], rng.uniform(-np.pi, 3*np.pi, n - 4)])
	dec = np.concatenate([[0.3, -0.2, 1.2, np.pi/2 - 1e-6], np.arcsin(rng.uniform(-1, 1, n - 4))])
	return np.array([ra, dec])


PAIRS = [("equ", "gal"), ("gal", "equ"), ("equ", "ecl"), ("ecl", "gal"), ("cel", "galactic"), ("icrs", "equ")]
FIELDS = {"plain": {}, "pol": {"pol": True}, "mag": {"mag": True}, "pol+mag": {"pol": True, "mag": True}}


@pytest.mark.parametrize("fields", FIELDS)
@pytest.mark.parametrize("isys,osys", PAIRS)
def test_transform_fixed_systems(isys, osys, fields):
	kw = FIELDS[fields]
	c = points(1)
	want = jcoordinates.transform(isys, osys, c, **kw)
	got = coordinates.transform(isys, osys, c, **kw)
	assert angerr(got, want) <= TOL
	# the device path, on CPU tensors
	dev = coordinates.transform(isys, osys, torch.from_numpy(c), **kw)
	assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
	assert angerr(dev.numpy(), got, np.cos(c[1])) <= TOL


RECENTERED = {
	"thumbnail": ("cel", ["cel", [np.array([0.0, 0.0, 1.1, -0.4]), False]]),
	"string": ("equ", "gal:10_20"),
	"string refsys": ("gal:10_-30:equ", "equ"),
	"restore": (["equ", [np.array([0.7, 0.2]), True]], "ecl"),
	"both": ("gal:5_5", "equ:30_-10"),
}


@pytest.mark.parametrize("name", RECENTERED)
def test_transform_recentered(name):
	isys, osys = RECENTERED[name]
	c = points(2)
	for kw in FIELDS.values():
		want = jcoordinates.transform(isys, osys, c, **kw)
		got = coordinates.transform(isys, osys, c, **kw)
		assert angerr(got, want) <= TOL, kw
		dev = coordinates.transform(isys, osys, torch.from_numpy(c), **kw)
		assert angerr(dev.numpy(), got, np.cos(c[1])) <= TOL, kw


def test_transform_extra_rows_and_unwind():
	"""A third input row is an angle to rotate, a fourth a magnification;
	unwind=True unwinds ra."""
	c = points(3, 50)
	c4 = np.concatenate([c, np.full((1, 50), 0.3), np.full((1, 50), 2.0)])
	for rows in (c4[:3], c4):
		want = jcoordinates.transform("equ", "gal", rows)
		assert angerr(coordinates.transform("equ", "gal", rows), want) <= TOL
		assert angerr(coordinates.transform("equ", "gal", torch.from_numpy(rows)).numpy(), want,
			np.cos(c[1])) <= TOL
	c = np.array([np.linspace(0, 12, 40), np.linspace(-0.5, 0.5, 40)])
	want = jcoordinates.transform("equ", "ecl", c, unwind=True)
	np.testing.assert_allclose(coordinates.transform("equ", "ecl", c, unwind=True), want, rtol=0, atol=TOL)
	dev = coordinates.transform("equ", "ecl", torch.from_numpy(c), unwind=True)
	np.testing.assert_allclose(dev.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("isys,osys", [("equ", "hor"), ("hor", "gal"), ("tele", "equ"), ("equ", "bore"),
	("bore", "hor"), ("hor", "tele")])
def test_transform_site_systems(isys, osys):
	"""The sidereal hor chain, the base tilt and the boresight, host only;
	a tensor goes through the host and comes back as a tensor."""
	c = points(4, 60)
	c[1] = np.abs(c[1])*0.9   # above the horizon, away from the zenith
	t = np.linspace(55000, 55001, 60)
	bore = np.array([0.4, 0.9])
	for kw in ({}, {"pol": True}):
		want = jcoordinates.transform(isys, osys, c, time=t, bore=bore, **kw)
		got = coordinates.transform(isys, osys, c, time=t, bore=bore, **kw)
		assert angerr(got, want) <= TOL
		dev = coordinates.transform(isys, osys, torch.from_numpy(c), time=t, bore=bore, **kw)
		assert isinstance(dev, torch.Tensor) and angerr(dev.numpy(), got) <= TOL


def test_rotations_and_helpers():
	c = points(5, 40)
	center = np.array([0.7, 0.2])
	for fn in ("recenter", "decenter"):
		for cen in (center, np.array([0.1, -0.3, 1.2, 0.5])):
			for restore in (False, True):
				want = getattr(jcoordinates, fn)(c, cen, restore=restore)
				assert angerr(getattr(coordinates, fn)(c, cen, restore=restore), want) <= TOL
	back = coordinates.decenter(coordinates.recenter(c, center), center)
	assert angerr(back, c) <= TOL
	eul = [0.3, -1.1, 2.0]
	np.testing.assert_array_equal(coordinates.euler_mat(eul), jcoordinates.euler_mat(eul))
	assert angerr(coordinates.euler_rot(eul, c), jcoordinates.euler_rot(eul, c)) <= TOL
	assert angerr(coordinates.euler_rot(eul, torch.from_numpy(c)).numpy(), jcoordinates.euler_rot(eul, c)) <= TOL
	for rows in (c, np.concatenate([c, np.full((1, 40), 0.2)])):
		assert angerr(coordinates.transform_euler(eul, rows), jcoordinates.transform_euler(eul, rows)) <= TOL
	np.testing.assert_array_equal(coordinates.gmst(np.array([55000.3, 56000.0])),
		jcoordinates.gmst(np.array([55000.3, 56000.0])))
	assert coordinates.getsys("Galactic") == jcoordinates.getsys("Galactic") == "gal"
	with pytest.raises(ValueError): coordinates.getsys("nowhere")
	assert coordinates.nohor("hor") == "icrs" and coordinates.get_handedness("tele") == "R"
	assert coordinates.make_mapping({"a": ["x", "y"]}) == jcoordinates.make_mapping({"a": ["x", "y"]})
	full = coordinates.getsys_full("gal:10_20:equ")
	wfull = jcoordinates.getsys_full("gal:10_20:equ")
	assert full[0] == wfull[0] and full[1][1] == wfull[1][1]
	assert np.abs(full[1][0] - wfull[1][0]).max() <= TOL
	for name in ("act", "so", "spt", "planck"):
		assert sites.get(name).lat == jsites.get(name).lat
		assert sites.expand_site(name) is sites.sites[name]
	assert sites.expand_weather(None, sites.default_site).pressure == jsites.default_weather.pressure
	with pytest.raises(ValueError): sites.expand_site("moon base")


def test_ephemeris_objects_raise():
	"""The ephemeris objects, once NotImplementedError, against the
	reference (the name is the earlier test's)."""
	c = points(6, 5)
	mjd = np.array([55500.0, 55500.3])
	calls = [lambda m: m.ephem_pos("Jupiter", 55500),
		lambda m: m.interpol_pos("equ", "gal", "Moon", mjd),
		lambda m: m.getsys_full("equ:Jupiter")[1][0],
		lambda m: m.getsys_full("gal:Sun", time=55501.5)[1][0],
		lambda m: m.transform("equ", "equ:Sun", c)]
	for call in calls:
		assert angerr(call(coordinates), call(jcoordinates)) <= TOL
	t = coordinates.transform("equ", "equ:Sun", torch.from_numpy(c))
	assert isinstance(t, torch.Tensor)
	assert angerr(t.numpy(), jcoordinates.transform("equ", "equ:Sun", c)) <= TOL
