"""pixell_tpu_torch.wcsutils against pixell_tpu.wcsutils, and the CEA / MER
repair it brings to curvedsky.

Both modules are host numpy, so pix2world / world2pix agree to a few ulp:
1e-9 degrees against the reference and 1e-7 pixels there and back in every
projection (CAR, CEA with its PV2_1 lambda, MER, the zenithal TAN, ZEA,
SIN, ARC, AIR, STG, plain) and with crval_dec != 0 on the cylindrical ones
(the native pole; x modulo the sky's period); AIR's pix2world only there
and back, since the reference's inverse does not converge. build,
finalize, pixelization and the helpers agree exactly. curvedsky.alm2map / map2alm of IQU at lmax 12 on a CEA and a MER band that
the port's own enmap.geometry builds (the reference takes its "cyl" path
there), and on a CAR with crval_dec != 0 (the general method in both),
agree with the reference within 1e-12 of the largest value (float64, CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import curvedsky as jcurvedsky, enmap as jenmap, \
	wcsutils as jwcsutils
from pixell_tpu_torch import curvedsky, enmap, utils, wcsutils

DEG = utils.degree


def port_wcs(w):
	"""A reference WCS carried across whole: pv, lonpole and latpole too."""
	return wcsutils.WCS.from_wcs(w)


def same_fields(w, jw):
	assert list(w.wcs.ctype) == list(jw.wcs.ctype)
	for f in ("crval", "crpix", "cdelt"):
		np.testing.assert_array_equal(np.asarray(getattr(w.wcs, f), float),
			np.asarray(getattr(jw.wcs, f), float))
	assert w.wcs.lonpole == jw.wcs.lonpole and w.wcs.latpole == jw.wcs.latpole
	assert w.wcs.get_pv() == jw.wcs.get_pv()


def ref_wcs(name):
	"""A reference WCS of each projection, some with crval_dec != 0."""
	if name == "plain": return jwcsutils.plain(np.array([0.5, -0.3]), res=0.01, shape=(40, 60))
	if name.startswith("car_dec"):   # CAR centred off the equator: the native pole is solved
		w = jwcsutils.car(np.array([30., 0.]), res=0.5, shape=(40, 60))
		w.wcs.crval = np.array([30., float(name[7:])])
		return w
	if name == "cea_lam":
		return jwcsutils.cea(np.array([[-20., -30.], [20., 30.]]), res=1.0, lam=0.7)
	if name == "mer_dec":
		w = jwcsutils.mer(np.array([10., 0.]), res=0.5, shape=(40, 60))
		w.wcs.crval = np.array([10., -25.])
		w.wcs.lonpole = 180.
		return w
	build = getattr(jwcsutils, name)
	if name in ("car", "cea", "mer"): return build(np.array([[-20., -30.], [20., 30.]]), res=1.0)
	return build(np.array([40., -30.]), res=0.2, shape=(50, 70))


PROJS = ["plain", "car", "cea", "cea_lam", "mer", "tan", "zea", "sin", "arc", "air", "stg",
	"car_dec30", "car_dec-45", "mer_dec"]


@pytest.mark.parametrize("name", PROJS)
def test_pix2world_world2pix(name):
	"""Pixel -> world -> pixel, and both against the reference."""
	if name == "stg":
		jw = jwcsutils.WCS(); jw.wcs.ctype = ["RA---STG", "DEC--STG"]
		jw.wcs.crval = np.array([40., -30.]); jw.wcs.cdelt = np.array([-0.2, 0.2])
		jw.wcs.crpix = np.array([35., 25.])
	else:
		jw = ref_wcs(name)
	w = port_wcs(jw)
	same_fields(w, jw)
	assert w == port_wcs(jw) and hash(w) == hash(w.deepcopy())
	rng = np.random.default_rng(1)
	x, y = rng.uniform(0, 60, 200), rng.uniform(0, 40, 200)
	lon, lat = wcsutils.pix2world(w, x, y)
	if name != "air":   # the reference's AIR inverse does not converge (ROADMAP Queue 3)
		jlon, jlat = jwcsutils.pix2world(jw, x, y)
		np.testing.assert_allclose(lon, np.asarray(jlon), rtol=0, atol=1e-9)
		np.testing.assert_allclose(lat, np.asarray(jlat), rtol=0, atol=1e-9)
	x2, y2 = wcsutils.world2pix(w, lon, lat)
	jx, jy = jwcsutils.world2pix(jw, lon, lat)
	np.testing.assert_allclose(x2, np.asarray(jx), rtol=0, atol=1e-9)
	np.testing.assert_allclose(y2, np.asarray(jy), rtol=0, atol=1e-9)
	# x comes back modulo the sky's period on the cylindrical projections
	per = 360/abs(w.wcs.cdelt[0]) if wcsutils.is_cyl(w) else np.inf
	np.testing.assert_allclose((x2 - x + per/2) % per - per/2 if wcsutils.is_cyl(w) else x2 - x, 0,
		rtol=0, atol=1e-7)
	np.testing.assert_allclose(y2, y, rtol=0, atol=1e-7)
	assert w.wcs_pix2world(x, y, 0)[0].shape == x.shape
	assert wcsutils.is_separable(w) == jwcsutils.is_separable(jw)
	assert wcsutils.is_azimuthal(w) == jwcsutils.is_azimuthal(jw)
	assert wcsutils.describe(w) == jwcsutils.describe(jw)


def test_header_roundtrip_and_from_fields():
	"""to_header / WCS(header=...) and from_fields carry pv, lonpole and latpole."""
	jw = ref_wcs("cea_lam")
	jw.wcs.latpole = 10.
	w = port_wcs(jw)
	assert w.wcs.get_pv() == [(2, 1, 0.7)] and w.wcs.latpole == 10.
	assert w.to_header() == jw.to_header()
	assert wcsutils.WCS(header=w.to_header()) == w
	f = wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt,
		pv={(2, 1): 0.7}, lonpole=None, latpole=10.)
	assert f == w and f != wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)
	assert wcsutils.equal(w, f) and not wcsutils.equal(w, port_wcs(ref_wcs("cea")))


@pytest.mark.parametrize("system", ["car", "cea", "mer", "plain", "tan", "zea", "arc", "sin", "air",
	"car:cc"])
def test_build(system):
	"""build from a box (cylindrical, plain) or a centre, with and without ref."""
	if system in ["car", "cea", "mer", "plain", "car:cc"]:
		pos = np.array([[-10., 25.], [12., -15.]])
		for ref in [None, "standard", (3., 4.)]:
			w = wcsutils.build(pos, res=0.7, rowmajor=True, system=system, ref=ref)
			jw = jwcsutils.build(pos, res=0.7, rowmajor=True, system=system, ref=ref)
			same_fields(w, jw)
		pos2, sh = pos, (30, 40)
	else:
		pos2, sh = np.array([40., -30.]), (30, 40)
	w = wcsutils.build(pos2, res=None if pos2.ndim == 2 else 0.3, shape=sh, system=system)
	jw = jwcsutils.build(pos2, res=None if pos2.ndim == 2 else 0.3, shape=sh, system=system)
	same_fields(w, jw)
	assert wcsutils.finalize(w, pos2) is w


@pytest.mark.parametrize("system", ["car", "cea", "mer", "tan", "zea", "arc", "sin", "plain"])
@pytest.mark.parametrize("variant", [None, "safe", "cc", "fejer1"])
def test_pixelization(system, variant):
	"""A projection-only wcs pixelized by res and by shape."""
	p, jp = wcsutils.projection(system), jwcsutils.projection(system)
	same_fields(p, jp)
	for kw in (dict(res=0.5), dict(res=[-0.5, 0.25]), dict(shape=(36, 72))):
		try:
			want = jwcsutils.pixelization(jp, variant=variant, **kw)
		except jwcsutils.PixelizationError:
			with pytest.raises(wcsutils.PixelizationError):
				wcsutils.pixelization(p, variant=variant, **kw)
			continue
		got = wcsutils.pixelization(p, variant=variant, **kw)
		assert got[0] == want[0]
		same_fields(got[1], want[1])


def test_helpers():
	"""The variant algebra, scale, compatibility, recentering and validation."""
	for name in ["safe", "fejer1", "cc", "any", "h0,0h"]:
		assert wcsutils.parse_variant(name) == jwcsutils.parse_variant(name)
	with pytest.raises(ValueError): wcsutils.parse_variant("xyz")
	for s in ["car", "CEA:cc", "tan"]:
		assert wcsutils.parse_system(s, "fejer1") == jwcsutils.parse_system(s, "fejer1")
	for args in [(180., None, 1.0, None), (10., 7, None, [0, 0]), (10., None, 1.0, [0.5, -0.5]),
			(10., None, 3.0, [None, 0])]:
		w, n, res, offs = args
		assert wcsutils.pixelize_1d(w, n=n, res=res, offs=offs) == \
			jwcsutils.pixelize_1d(w, n=n, res=res, offs=offs)
	for s in ["car", "cea", "mer", "arc", "zea", "sin", "tan", "plain"]:
		assert wcsutils.default_extent(s) == jwcsutils.default_extent(s)
		assert wcsutils.default_variant(s) == jwcsutils.default_variant(s)
		assert wcsutils.is_periodic(s) == jwcsutils.is_periodic(s)
		assert wcsutils.default_crval(s) == jwcsutils.default_crval(s)
	np.testing.assert_array_equal(wcsutils.expand_res(0.5, flip=True), jwcsutils.expand_res(0.5, flip=True))
	jw = ref_wcs("car")
	w = port_wcs(jw)
	for sc, kw in [(2, {}), ([2, 0.5], dict(rowmajor=True)), (3, dict(corner=False))]:
		same_fields(wcsutils.scale(w, sc, **kw), jwcsutils.scale(jw, sc, **kw))
	same_fields(wcsutils.fix_wcs(w), jwcsutils.fix_wcs(jw))
	same_fields(wcsutils.recenter_cyl_x(w, 7.5), jwcsutils.recenter_cyl_x(jw, 7.5))
	same_fields(wcsutils.recenter_cyl_ra(w, 3.), jwcsutils.recenter_cyl_ra(jw, 3.))
	same_fields(wcsutils.center_cyl_wcs(w, (40, 60)), jwcsutils.center_cyl_wcs(jw, (40, 60)))
	w2 = w.deepcopy(); w2.wcs.crpix = w2.wcs.crpix + [3, -2]; w2.wcs.crval = w2.wcs.crval + [3, -2]
	w3 = w.deepcopy(); w3.wcs.crpix = w3.wcs.crpix + [0.4, 0]
	assert wcsutils.is_compatible(w, w2) and not wcsutils.is_compatible(w, w3)
	assert not wcsutils.is_compatible(w, port_wcs(ref_wcs("cea")))
	for args in [([1., 2.], 0.5, None), ([[1., 2.], [3., 4.]], None, (10, 20)),
			([[1., 2.], [3., 4.]], [0.1, 0.2], (10, 20), True)]:
		got, want = wcsutils.validate(*args), jwcsutils.validate(*args)
		for a, b in zip(got, want):
			np.testing.assert_array_equal(np.asarray(a, float) if a is not None else np.nan,
				np.asarray(b, float) if b is not None else np.nan)
	lon1, lat1, lon2, lat2 = 0.1, 0.2, 0.4, -0.3
	assert wcsutils.angdist(lon1, lat1, lon2, lat2) == jwcsutils.angdist(lon1, lat1, lon2, lat2)
	assert wcsutils.extent2bounds([2, 4]) == jwcsutils.extent2bounds([2, 4])
	same_fields(wcsutils.explicit(crval=[1, 2], cdelt=[3, 4], crpix=[5, 6], ctype=["RA---TAN", "DEC--TAN"]),
		jwcsutils.explicit(crval=[1, 2], cdelt=[3, 4], crpix=[5, 6], ctype=["RA---TAN", "DEC--TAN"]))
	assert wcsutils.nobcheck(w) is w and wcsutils.fix_cdelt(w) == w
	assert wcsutils.streq("a", "a") and not wcsutils.streq(1, "a")
	with pytest.raises(ValueError):
		wcsutils.build(np.array([0., 0.]), res=1, shape=(2, 2), system="xyz")


# ---------------------------------------------------------------------------
# curvedsky on CEA / MER bands and on a CAR off the equator
# ---------------------------------------------------------------------------
LMAX = 12


def rand_alm(seed, ncomp=3):
	n = (LMAX + 1)*(LMAX + 2)//2
	rng = np.random.default_rng(seed)
	a = rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n))
	a[:, :LMAX+1] = a[:, :LMAX+1].real
	return a


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def band(proj):
	"""(port geometry, reference geometry) of the 60 x 40 degree band, or a
	CAR whose crval_dec is 20 degrees."""
	if proj == "car_dec":
		shape, w = enmap.geometry(np.array([10., 0.])*DEG, res=1.5*DEG, shape=(30, 40), proj="car")
		w.wcs.crval = np.array([w.wcs.crval[0], 20.])
		jw = jwcsutils.WCS(); jw.wcs.ctype = list(w.wcs.ctype)
		jw.wcs.crval, jw.wcs.crpix, jw.wcs.cdelt = w.wcs.crval.copy(), w.wcs.crpix.copy(), w.wcs.cdelt.copy()
		return (shape, w), (shape, jw)
	pos = np.array([[-30, -20], [30, 20]])*DEG
	return enmap.geometry(pos, res=1*DEG, proj=proj), jenmap.geometry(pos, res=1*DEG, proj=proj)


@pytest.mark.parametrize("proj", ["cea", "mer", "car_dec"])
def test_curvedsky_on_band(proj):
	"""The port's geometry equals the reference's (CEA: shape (57, 40), pv
	carried), analyse_geometry takes the reference's case ("cyl", or
	"general" for crval_dec != 0), and IQU alm2map / map2alm agree."""
	(shape, w), (jshape, jw) = band(proj)
	assert shape == tuple(int(n) for n in jshape)
	same_fields(w, jw)
	same_fields(port_wcs(jw), jw)
	if proj == "cea": assert shape == (57, 40) and w.wcs.get_pv() == [(2, 1, 1.0)]
	case = curvedsky.analyse_geometry(shape, w).case
	assert case == jcurvedsky.analyse_geometry(jshape, jw).case == ("general" if proj == "car_dec" else "cyl")
	a = rand_alm(3)
	m = curvedsky.alm2map(torch.from_numpy(a), enmap.zeros((3,) + shape, w, device="cpu"), spin=[0, 2])
	jm = jcurvedsky.alm2map(jnp.asarray(a), jenmap.zeros((3,) + jshape, jw), spin=[0, 2])
	assert rel(m.data.numpy(), jm) <= 1e-12
	b = curvedsky.map2alm(m, lmax=LMAX, spin=[0, 2])
	jb = jcurvedsky.map2alm(jm, lmax=LMAX, spin=[0, 2])
	assert rel(b.numpy(), jb) <= 1e-12
