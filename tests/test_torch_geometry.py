"""pixell_tpu_torch geometry layer against pixell_tpu: utils, wcsutils,
enmap, fft helpers and curvedsky.analyse_geometry. All of it is host
numpy maths, so agreement is exact (or to a few ulp where the two
packages round through different expressions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, utils as jutils, wcsutils as jwcs, \
	curvedsky as jcurvedsky, fft as jfft
from pixell_tpu_torch import enmap, utils, wcsutils, curvedsky, fft, bunch


def to_port_wcs(wcs):
	return wcsutils.WCS.from_fields(wcs.wcs.ctype, wcs.wcs.crval, wcs.wcs.crpix,
		wcs.wcs.cdelt)


def assert_same_wcs(twcs, jw):
	assert list(twcs.wcs.ctype) == list(jw.wcs.ctype)
	for f in ("crval", "crpix", "cdelt"):
		np.testing.assert_array_equal(getattr(twcs.wcs, f), getattr(jw.wcs, f))


@pytest.mark.parametrize("variant", ["cc", "fejer1"])
@pytest.mark.parametrize("res", [1.0, 12/60])
def test_fullsky_geometry(variant, res):
	jshape, jw = jenmap.fullsky_geometry(res=res*jutils.degree, variant=variant)
	shape, w = enmap.fullsky_geometry(res=res*utils.degree, variant=variant)
	assert shape == jshape
	assert_same_wcs(w, jw)
	# posaxes: identical host maths
	for a, b in zip(enmap.posaxes(shape, w), jenmap.posaxes(jshape, jw)):
		np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)


def test_wcs_from_fields_roundtrip():
	jshape, jw = jenmap.fullsky_geometry(res=0.5*jutils.degree, variant="cc")
	w = to_port_wcs(jw)
	assert_same_wcs(w, jw)
	assert w == w.deepcopy() and hash(w) == hash(w.deepcopy())
	assert wcsutils.get_proj(w) == "car" and wcsutils.is_cyl(w)
	assert wcsutils.is_separable(w) and not wcsutils.is_plain(w)
	rng = np.random.default_rng(0)
	x, y = rng.uniform(0, 720, 50), rng.uniform(0, 360, 50)
	for a, b in zip(wcsutils.pix2world(w, x, y), jwcs.pix2world(jw, x, y)):
		np.testing.assert_allclose(a, np.asarray(b), atol=1e-12)
	lon, lat = wcsutils.pix2world(w, x, y)
	for a, b in zip(wcsutils.world2pix(w, lon, lat), jwcs.world2pix(jw, lon, lat)):
		np.testing.assert_allclose(a, np.asarray(b), atol=1e-9)
	# the other projections are ported too (tests/test_torch_wcsutils.py holds them all)
	tan = wcsutils.WCS.from_fields(["RA---TAN", "DEC--TAN"], [0, 0], [1, 1], [1, 1])
	jtan = jwcs.WCS()
	jtan.wcs.ctype, jtan.wcs.crval = ["RA---TAN", "DEC--TAN"], np.zeros(2)
	jtan.wcs.crpix, jtan.wcs.cdelt = np.ones(2), np.ones(2)
	for a, b in zip(wcsutils.pix2world(tan, x/10, y/10), jwcs.pix2world(jtan, x/10, y/10)):
		np.testing.assert_allclose(a, np.asarray(b), atol=1e-12)


def _geoms():
	"""Full-sky grids and a band cut from one (the band needs y padding)."""
	out = []
	for variant in ["cc", "fejer1"]:
		shape, wcs = jenmap.fullsky_geometry(shape=(31 + (variant == "cc"), 64),
			variant=variant)
		out.append((shape, wcs))
	shape, wcs = jenmap.fullsky_geometry(shape=(40, 80), variant="fejer1")
	out.append(jenmap.slice_geometry(shape, wcs, (slice(7, 29), slice(None))))
	return out


@pytest.mark.parametrize("i", range(3))
def test_analyse_geometry(i):
	shape, jw = _geoms()[i]
	ref = jcurvedsky.analyse_geometry(shape, jw)
	got = curvedsky.analyse_geometry(shape, to_port_wcs(jw))
	assert got.case == ref.case == "2d"
	assert got.variant == ref.variant
	assert list(got.flip) == [bool(f) for f in ref.flip]
	assert tuple(got.ypad) == tuple(int(v) for v in ref.ypad)
	assert tuple(got.xpad) == tuple(int(v) for v in ref.xpad)
	assert got.nphi == ref.nphi
	np.testing.assert_allclose(got.phi0, ref.phi0, atol=1e-14)
	np.testing.assert_allclose(got.theta, ref.theta, atol=1e-14)


def test_ndmap_container():
	shape, w = enmap.fullsky_geometry(shape=(10, 20), variant="fejer1")
	m = enmap.zeros(shape, w, dtype=torch.float32, device="cpu")
	assert m.shape == shape and m.dtype == torch.float32 and m.device.type == "cpu"
	assert enmap.samewcs(torch.ones(shape), m).wcs is w
	e = enmap.empty((2,) + shape, w, device="cpu")
	assert e.shape == (2,) + shape and e.dtype == torch.float64
	assert np.asarray(m).shape == shape
	np.testing.assert_allclose(m.pix2sky(np.array([[0.0], [0.0]])),
		jenmap.pix2sky(shape, jenmap.fullsky_geometry(shape=(10, 20),
			variant="fejer1")[1], np.array([[0.0], [0.0]])), atol=1e-14)


def test_utils_and_fft_helpers():
	a = np.array([-3.7, 0.5, 2.5, 7.2])
	np.testing.assert_array_equal(utils.nint(a), jutils.nint(a))
	np.testing.assert_allclose(utils.rewind(a*3, 1.0), jutils.rewind(a*3, 1.0))
	rng = np.random.default_rng(1)
	M = rng.standard_normal((5, 3, 3)); M = M @ np.swapaxes(M, -1, -2)
	for e in (0.5, -1, 2):
		np.testing.assert_allclose(utils.eigpow(M, e), np.asarray(jutils.eigpow(M, e)),
			rtol=1e-12, atol=1e-12)
	for n in [1, 97, 1001, 4003, 10003]:
		for d in ["above", "below"]:
			assert fft.fft_len(n, d) == jfft.fft_len(n, d)
	x = rng.standard_normal((3, 10)) + 1j*rng.standard_normal((3, 10))
	for n in [7, 10, 16, 25]:
		for xx in (x, x[:, :9]):
			np.testing.assert_allclose(fft.resample(torch.from_numpy(xx), n).numpy(),
				np.asarray(jfft.resample(xx, n)), atol=1e-14)
	b = bunch.Bunch(a=1, b=2)
	b.c = 3
	assert b.a + b["b"] + b.c == 6 and "c" in b and len(b) == 3
