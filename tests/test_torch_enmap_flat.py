"""pixell_tpu_torch.enmap's ndmap class, geometry functions and flat-sky
Fourier side against pixell_tpu.enmap on the CPU in float64, with inputs
made from a numpy seed on a 24 x 40 CAR patch (3 components for IQU), so
each reference program compiles once:

- ndmap arithmetic keeping the wcs (ndmap, tensor, numpy array and scalar
  on either side; in place), slicing with negative steps against the
  reference's wcs and data, assignment, at_, iteration;
- geometry, band_geometry, extent, area, pixel sizes and shapes, the
  coordinate helpers, on CAR, CEA, MER, TAN, ZEA and plain geometries;
- fft / ifft with every normalization, the DCT pair and their adjoints;
  map2harm / harm2map for IQU with iau both ways and spin [0, 1]; the
  adjoints by dot product (1e-12 relative);
- lmap, modlmap, lrmap, modrmap, lbin, rbin, calc_ps2d, smooth_gauss,
  apply_window, rotate_pol, queb_rotmat, map_mul, grad, grad_pix, div,
  laplace, shifts, fftshift;
- spec2flat and the flat random fields from one seed against the
  reference;
- the l axes copied to the device once per geometry, and the new entry
  points on CUDA by default.

Tolerance: 1e-12 of the largest reference value (host maths and FFTs of
at most 960 points); the binned spectra hold the same bound because both
sides sum in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap
from pixell_tpu_torch import enmap, utils, wcsutils

DEG = utils.degree
SHAPE = (24, 40)
POS = np.array([[-5, 8], [3, -6]])*DEG
TOL = 1e-12


def rel(got, want):
	got = got.data if isinstance(got, enmap.ndmap) else got
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def geo():
	"""(port geometry, reference geometry) of the CAR patch."""
	return enmap.geometry(POS, shape=SHAPE, proj="car"), jenmap.geometry(POS, shape=SHAPE, proj="car")


def maps(ncomp=3, seed=0, cplx=False):
	(shape, w), (_, jw) = geo()
	rng = np.random.default_rng(seed)
	x = rng.standard_normal((ncomp,) + shape if ncomp else shape)
	if cplx: x = x + 1j*rng.standard_normal(x.shape)
	return enmap.enmap(x, w, device="cpu"), jenmap.enmap(x, jw), x


# ---------------------------------------------------------------------------
# the ndmap class
# ---------------------------------------------------------------------------
def test_arithmetic_keeps_wcs():
	m, _, x = maps()
	t = torch.from_numpy(x)
	a = np.full(x.shape, 2.0)
	for got, want in [(m + 1, x + 1), (2*m, 2*x), (m - t, 0*x), (t + m, 2*x), (a*m, a*x), (m/a, x/a),
			(a - m, a - x), (m**2, x**2), (-m, -x), (abs(m), abs(x)), (np.float64(3)*m, 3*x),
			(m @ torch.ones(SHAPE[1], 1, dtype=torch.float64), x.sum(-1, keepdims=True)),
			(torch.sin(m), np.sin(x)), (torch.stack([m, m]), np.stack([x, x]))]:
		assert isinstance(got, enmap.ndmap) and got.wcs == m.wcs
		np.testing.assert_allclose(got.data.numpy(), want, rtol=0, atol=1e-14)
	assert isinstance(m > 0, enmap.ndmap) and bool(((m > 0).data == torch.from_numpy(x > 0)).all())
	assert not isinstance(torch.sum(m), enmap.ndmap)
	c = m.copy()
	c += 1
	c *= a
	c -= t
	assert isinstance(c, enmap.ndmap) and c.wcs == m.wcs
	np.testing.assert_allclose(c.data.numpy(), (x + 1)*2 - x, atol=1e-14)
	np.testing.assert_array_equal(m.data.numpy(), x)   # copy() is deep
	m32 = m.astype(np.float32)
	assert m32.dtype == torch.float32 and (m32 + np.ones(x.shape)).dtype == torch.float64
	assert (m32 + 1.5).dtype == torch.float32


def test_methods():
	m, jm, x = maps()
	assert m.shape == jm.shape and m.ndim == 3 and m.npix() == jm.npix() and len(m) == 3
	assert m.size == x.size and m.nbytes == x.nbytes and m.geometry == (m.shape, m.wcs)
	assert m.preflat().shape == (3,) + SHAPE and m.reshape(3, -1).shape == (3, SHAPE[0]*SHAPE[1])
	np.testing.assert_allclose(float(m.sum()), x.sum(), rtol=1e-14)
	np.testing.assert_allclose(m.mean(axis=(-2, -1)).numpy(), x.mean((-2, -1)), rtol=1e-14)
	np.testing.assert_allclose(m.std(axis=0).numpy(), x.std(0), rtol=1e-13)
	np.testing.assert_allclose(m.var().numpy(), x.var(), rtol=1e-13)
	assert float(m.min()) == x.min() and np.array_equal(m.max(axis=1).numpy(), x.max(1))
	mc, _, xc = maps(cplx=True)
	for got, want in [(mc.real, xc.real), (mc.imag, xc.imag), (mc.conj(), xc.conj()), (m.T, x.T)]:
		assert got.wcs == m.wcs
		np.testing.assert_array_equal(got.data.numpy(), want)
	assert m.copy().fill(2.0).data.eq(2).all()
	np.testing.assert_array_equal(np.asarray(m), x)
	assert m.plain().wcs.wcs.ctype == ["", ""] and [i.shape for i in m] == [SHAPE]*3


SELS = [(0,), (slice(None), slice(2, 20, 3)), (Ellipsis, slice(None, None, -1), slice(None)),
	(Ellipsis, slice(20, 3, -2), slice(None, None, -3)), (slice(1, None), slice(5, 1, -1), slice(30, 2, -4)),
	(Ellipsis, 3, slice(None)), (0, slice(None), None), (1, slice(None, None, -1), 7),
	(Ellipsis, slice(2, 10), slice(None, None, -1))]


@pytest.mark.parametrize("i", range(len(SELS)))
def test_slicing(i):
	"""Slices, negative steps included, give the reference's data and wcs;
	an integer or None on a pixel axis gives a bare tensor."""
	m, jm, x = maps()
	sel = SELS[i]
	got, want = m[sel], jm[sel]
	gd = got.data if isinstance(got, enmap.ndmap) else got
	np.testing.assert_array_equal(gd.numpy(), np.asarray(want))
	assert isinstance(got, enmap.ndmap) == isinstance(want, jenmap.ndmap)
	if isinstance(got, enmap.ndmap):
		for f in ("crval", "crpix", "cdelt"):
			np.testing.assert_allclose(getattr(got.wcs.wcs, f), getattr(want.wcs.wcs, f), rtol=0, atol=1e-12)


def test_setitem_and_at():
	m, _, x = maps()
	y = x.copy()
	m[..., ::-1, 2:10] = np.arange(24*8.).reshape(24, 8)
	y[..., ::-1, 2:10] = np.arange(24*8.).reshape(24, 8)
	m[0, 5:1:-2, :] = 7.0
	y[0, 5:1:-2, :] = 7.0
	m[1] = m[2]
	y[1] = y[2]
	np.testing.assert_array_equal(m.data.numpy(), y)
	n = m.at_[..., 3:0:-1, 0].add(1.0)
	z = y.copy(); z[..., 3:0:-1, 0] += 1.0
	np.testing.assert_array_equal(n.data.numpy(), z)
	np.testing.assert_array_equal(m.data.numpy(), y)   # out of place
	np.testing.assert_array_equal(m.at_[0].set(np.ones(SHAPE)).data[0].numpy(), np.ones(SHAPE))
	np.testing.assert_array_equal(m.at_[:, 0, 0].max(100.).data[:, 0, 0].numpy(), [100.]*3)
	np.testing.assert_array_equal(m.at_[:, 0, 0].multiply(2.).data[:, 0, 0].numpy(), 2*y[:, 0, 0])
	np.testing.assert_array_equal(m.at_[:, 0, 0].min(-100.).data[:, 0, 0].numpy(), [-100.]*3)


def test_constructors():
	(shape, w), (_, jw) = geo()
	for m in (enmap.ones(shape, w, device="cpu"), enmap.full(shape, w, 1.0, device="cpu"),
			enmap.enmap(np.ones(shape), w, device="cpu"), enmap.zeros(shape, w, device="cpu") + 1):
		assert m.dtype == torch.float64 and m.wcs == w and bool(m.data.eq(1).all())
	assert enmap.full(shape, w, 3, device="cpu").dtype == torch.int64
	assert enmap.ones(shape, w, np.float32, device="cpu").dtype == torch.float32
	t = torch.arange(6.).reshape(2, 3)
	e = enmap.enmap(t, w)
	assert e.data is not t and e.device == t.device and enmap.enmap(t, w, copy=False).data is t
	s = enmap.enmap([e, e])
	assert s.shape == (2, 2, 3) and s.wcs == w
	g = enmap.Geometry((3,) + shape, w)
	jg = jenmap.Geometry((3,) + shape, jw)
	sub, jsub = g[1:, ::-2, 3:9], jg[1:, ::-2, 3:9]
	assert sub.shape == jsub.shape and np.allclose(sub.wcs.wcs.crpix, jsub.wcs.wcs.crpix)
	assert g.npix == jg.npix and g.nopre.shape == shape and g.with_pre((5,)).shape == (5,) + shape
	assert tuple(g) == ((3,) + shape, w) and g == g.copy() and len(g) == 2
	sc, jsc = g.scale(2), jg.scale(2)
	assert sc.shape == jsc.shape and np.allclose(sc.wcs.wcs.cdelt, jsc.wcs.wcs.cdelt)
	assert enmap.geometry_of(e).shape == e.shape


# ---------------------------------------------------------------------------
# geometry, coordinates, extent and area
# ---------------------------------------------------------------------------
def ref_geometry(kind):
	if kind == "car_box": return dict(pos=POS, shape=SHAPE, proj="car")
	if kind == "car_res": return dict(pos=POS, res=0.25*DEG, proj="car")
	if kind == "cea": return dict(pos=np.array([[-30, -20], [30, 20]])*DEG, res=1*DEG, proj="cea")
	if kind == "mer": return dict(pos=np.array([[-30, -20], [30, 20]])*DEG, res=1*DEG, proj="mer")
	if kind == "tan": return dict(pos=np.array([-20, 40])*DEG, res=0.2*DEG, shape=(30, 36), proj="tan")
	if kind == "zea": return dict(pos=np.array([60, 10])*DEG, res=0.5*DEG, shape=(20, 24), proj="zea")
	if kind == "car_deg": return dict(pos=[[-5, 8], [3, -6]], res=0.5, proj="car", deg=True)
	if kind == "plain": return dict(pos=[[0, 0], [1, 2]], res=0.05, proj="plain")


GEOMS = ["car_box", "car_res", "cea", "mer", "tan", "zea", "car_deg", "plain"]


@pytest.mark.parametrize("kind", GEOMS)
def test_geometry_extent_area(kind):
	kw = ref_geometry(kind)
	shape, w = enmap.geometry(**kw)
	jshape, jw = jenmap.geometry(**kw)
	assert shape == tuple(int(n) for n in jshape) and all(type(n) is int for n in shape)
	for f in ("crval", "crpix", "cdelt"):
		np.testing.assert_array_equal(getattr(w.wcs, f), getattr(jw.wcs, f))
	assert w.wcs.get_pv() == jw.wcs.get_pv() and w.wcs.lonpole == jw.wcs.lonpole
	close = lambda a, b: np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=1e-12,
		atol=1e-15)
	for method in ["auto", "intermediate", "cylindrical", "subgrid"]:
		close(enmap.extent(shape, w, method=method, signed=True), jenmap.extent(jshape, jw, method=method,
			signed=True))
	close(enmap.extent_intermediate(shape, w), jenmap.extent_intermediate(jshape, jw))
	close(enmap.extent_subgrid(shape, w, nsub=8), jenmap.extent_subgrid(jshape, jw, nsub=8))
	close(enmap.area(shape, w), jenmap.area(jshape, jw))
	close(enmap.area_intermediate(shape, w), jenmap.area_intermediate(jshape, jw))
	close(enmap.area_contour(shape, w, nsamp=200), jenmap.area_contour(jshape, jw, nsamp=200))
	close(enmap.pixsize(shape, w), jenmap.pixsize(jshape, jw))
	close(enmap.pixshape(shape, w, signed=True), jenmap.pixshape(jshape, jw, signed=True))
	close(enmap.pixsizemap(shape, w, device="cpu").data, jenmap.pixsizemap(jshape, jw))
	close(enmap.pixshapemap(shape, w, device="cpu").data, jenmap.pixshapemap(jshape, jw))
	close(enmap.pixshapebounds(shape, w), jenmap.pixshapebounds(jshape, jw))
	close(enmap.pixsizemap_contour(shape, w, bsize=7, device="cpu").data,
		jenmap.pixsizemap_contour(jshape, jw, bsize=7))
	if wcsutils.is_cyl(w):
		close(enmap.area_cyl(shape, w), jenmap.area_cyl(jshape, jw))
		close(enmap.pixshapes_cyl(shape, w, signed=True), jenmap.pixshapes_cyl(jshape, jw, signed=True))
		close(enmap.extent_cyl(shape, w), jenmap.extent_cyl(jshape, jw))
	for f in ("corners", "box", "center"):
		close(getattr(enmap, f)(shape, w), getattr(jenmap, f)(jshape, jw))
	pix = np.array([[0.5, 3.0, shape[-2] - 1.2], [1.5, shape[-1]/2, 0.0]])
	sky = enmap.pix2sky(shape, w, pix)
	close(sky, jenmap.pix2sky(jshape, jw, pix))
	for safe in (True, 2):
		close(enmap.sky2pix(shape, w, sky, safe=safe), jenmap.sky2pix(jshape, jw, sky, safe=safe))
	np.testing.assert_allclose(enmap.sky2pix(shape, w, sky), pix, rtol=0, atol=1e-9)
	assert np.array_equal(enmap.contains(shape, w, sky), jenmap.contains(jshape, jw, sky))
	close(enmap.pix2l(shape, w, pix), jenmap.pix2l(jshape, jw, pix))
	close(enmap.l2pix(shape, w, enmap.pix2l(shape, w, pix)), jenmap.l2pix(jshape, jw, jenmap.pix2l(jshape,
		jw, pix)))
	close(enmap.lpixshape(shape, w), jenmap.lpixshape(jshape, jw))
	close(enmap.lpixsize(shape, w), jenmap.lpixsize(jshape, jw))
	lw, jlw = enmap.lwcs(shape, w), jenmap.lwcs(jshape, jw)
	close(lw.wcs.cdelt, jlw.wcs.cdelt)
	close(lw.wcs.crpix, jlw.wcs.crpix)
	close(enmap.posmap(shape, w, device="cpu").data, jenmap.posmap(jshape, jw))
	assert np.array_equal(enmap.pixmap(shape, w, device="cpu").data.numpy(), np.asarray(jenmap.pixmap(jshape, jw)))


@pytest.mark.parametrize("dec", [[-63, 23], [40]])
def test_band_geometry(dec):
	res = 2*utils.arcmin*60
	shape, w = enmap.band_geometry(np.array(dec)*DEG, res=res, dims=(3,))
	jshape, jw = jenmap.band_geometry(np.array(dec)*DEG, res=res, dims=(3,))
	assert shape == tuple(jshape)
	for f in ("crval", "crpix", "cdelt"):
		np.testing.assert_array_equal(getattr(w.wcs, f), getattr(jw.wcs, f))
	fs, fw = enmap.fullsky_geometry(res=res)
	assert shape[-1] == fs[-1] and shape[-2] < fs[-2]
	with pytest.raises(ValueError): enmap.band_geometry(np.array([20, 10])*DEG, res=res)


# ---------------------------------------------------------------------------
# the Fourier side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalize", [True, False, "phys"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_fft_normalizations(normalize, adjoint):
	m, jm, x = maps()
	f = enmap.fft(m, normalize=normalize, adjoint_ifft=adjoint)
	jf = jenmap.fft(jm, normalize=normalize, adjoint_ifft=adjoint)
	assert f.wcs == m.wcs and rel(f, jf) <= TOL
	b = enmap.ifft(f, normalize=normalize, adjoint_fft=adjoint)
	assert rel(b, jenmap.ifft(jf, normalize=normalize, adjoint_fft=adjoint)) <= TOL
	if normalize and not adjoint: assert rel(b.real, x) <= TOL
	f32 = enmap.fft(m.astype(np.float32), normalize=normalize)
	assert f32.dtype == torch.complex64 and rel(f32, jf if not adjoint else
		jenmap.fft(jm, normalize=normalize)) <= 1e-6


def test_dct_and_adjoints():
	m, jm, x = maps()
	for got, want in [(enmap.dct(m), jenmap.dct(jm)), (enmap.idct(m), jenmap.idct(jm)),
			(enmap.dct(m, normalize=False), jenmap.dct(jm, normalize=False)),
			(enmap.dct_adjoint(m), jenmap.dct_adjoint(jm)), (enmap.idct_adjoint(m), jenmap.idct_adjoint(jm)),
			(enmap.fft_adjoint(m), jenmap.fft_adjoint(jm)), (enmap.ifft_adjoint(m), jenmap.ifft_adjoint(jm)),
			(m.fft(), jm.fft()), (m.ifft(normalize="phys"), jm.ifft(normalize="phys"))]:
		assert rel(got, want) <= TOL
	out = enmap.zeros(m.shape, m.wcs, torch.complex128, device="cpu")
	assert enmap.fft(m, omap=out).data.data_ptr() == out.data.data_ptr()


@pytest.mark.parametrize("iau", [False, True])
@pytest.mark.parametrize("spin", [[0, 2], [0, 1]])
@pytest.mark.parametrize("normalize", [True, "phys"])
def test_map2harm_harm2map(iau, spin, normalize):
	m, jm, x = maps()
	h = enmap.map2harm(m, normalize=normalize, iau=iau, spin=spin)
	jh = jenmap.map2harm(jm, normalize=normalize, iau=iau, spin=spin)
	assert rel(h, jh) <= TOL
	b = enmap.harm2map(h, normalize=normalize, iau=iau, spin=spin)
	assert rel(b, jenmap.harm2map(jh, normalize=normalize, iau=iau, spin=spin)) <= TOL
	assert rel(b, x) <= TOL and b.dtype == torch.float64
	ki = enmap.harm2map(h, normalize=normalize, iau=iau, spin=spin, keep_imag=True)
	assert ki.dtype == torch.complex128 and float(ki.data.imag.abs().max()) <= 1e-12
	h32 = enmap.map2harm(m.astype(np.float32), normalize=normalize, iau=iau, spin=spin)
	assert h32.dtype == torch.complex64 and rel(h32, jh) <= 1e-6


@pytest.mark.parametrize("spin", [[0, 2], [0, 1]])
def test_adjoints_dot_product(spin):
	"""<map2harm x, y> = <x, map2harm_adjoint y> (real inner products), and
	the same for harm2map, fft and ifft."""
	m, _, x = maps(seed=1)
	y = maps(seed=2, cplx=True)[0]
	dot = lambda a, b: float((a.data.conj()*b.data).real.sum()) if a.data.is_complex() or b.data.is_complex() \
		else float((a.data*b.data).sum())
	for fwd, adj in [(lambda v: enmap.map2harm(v, spin=spin, normalize="phys"),
			lambda v: enmap.map2harm_adjoint(v, spin=spin, normalize="phys")),
			(lambda v: enmap.fft(v, normalize="phys"), lambda v: enmap.fft_adjoint(v, normalize="phys").real),
			(lambda v: enmap.map2harm(v, spin=spin, iau=True), lambda v: enmap.map2harm_adjoint(v, spin=spin,
				iau=True))]:
		lhs, rhs = dot(fwd(m), y), dot(m, adj(y))
		assert abs(lhs - rhs) <= 1e-12*abs(lhs)
	# harm2map's adjoint: <harm2map h, x> = <h, harm2map_adjoint x> on Hermitian h
	h = enmap.map2harm(maps(seed=3)[0], spin=spin)
	lhs = dot(enmap.harm2map(h, spin=spin), m)
	rhs = dot(h, enmap.harm2map_adjoint(m, spin=spin))
	assert abs(lhs - rhs) <= 1e-12*abs(lhs)
	lhs = dot(enmap.ifft(y, normalize="phys"), y)
	rhs = dot(y, enmap.ifft_adjoint(y, normalize="phys"))
	assert abs(lhs - rhs) <= 1e-12*abs(lhs)


def test_fourier_coordinates():
	(shape, w), (jshape, jw) = geo()
	for f in ("lmap", "modlmap", "lrmap"):
		assert rel(getattr(enmap, f)(shape, w, device="cpu"), getattr(jenmap, f)(jshape, jw)) <= TOL
	assert rel(enmap.modlmap(shape, w, min=500, device="cpu"), jenmap.modlmap(jshape, jw, min=500)) <= TOL
	assert rel(enmap.lmap(shape, w, oversample=2, device="cpu"), jenmap.lmap(jshape, jw, oversample=2)) == 0
	for a, b in zip(enmap.laxes(shape, w), jenmap.laxes(jshape, jw)): np.testing.assert_array_equal(a, b)
	for ref in ["center", [0.01, -0.02]]:
		assert rel(enmap.modrmap(shape, w, ref=ref, device="cpu"), jenmap.modrmap(jshape, jw, ref=ref)) <= TOL
	m, jm, x = maps()
	assert rel(m.lform(), jenmap.lform(jm)) == 0 and rel(enmap.fftshift(m), jenmap.fftshift(jm)) == 0
	assert rel(enmap.ifftshift(enmap.fftshift(m)), x) == 0
	q = enmap.queb_rotmat(enmap.lmap(shape, w, device="cpu"), inverse=True, iau=True)
	assert q.wcs == w and rel(q, jenmap.queb_rotmat(jenmap.lmap(jshape, jw), inverse=True, iau=True)) <= TOL
	assert rel(enmap.map_mul(q, m[1:]), jenmap.map_mul(np.asarray(q.data), jm[1:])) <= TOL


@pytest.mark.parametrize("cplx", [False, True])
def test_lbin_rbin(cplx):
	m, jm, x = maps(cplx=cplx)
	h = enmap.map2harm(m)
	ps, jps = enmap.calc_ps2d(h), jenmap.calc_ps2d(jenmap.map2harm(jm))
	assert rel(ps, jps) <= TOL
	assert rel(enmap.calc_ps2d(h, h[::-1]), jenmap.calc_ps2d(jenmap.map2harm(jm), jenmap.map2harm(jm)[::-1])) <= TOL
	src, jsrc = (h, jenmap.map2harm(jm)) if cplx else (ps, jps)
	for kw in (dict(), dict(bsize=300.), dict(brel=2.5)):
		v, c, n = enmap.lbin(src, return_nhit=True, **kw)
		jv, jc, jn = jenmap.lbin(jsrc, return_nhit=True, **kw)
		assert v.dtype == src.dtype and rel(v, jv) <= TOL and rel(c, jc) == 0
		assert np.array_equal(n.numpy(), jn)
	for kw in (dict(), dict(center=[0.01, -0.02], bsize=0.002)):
		v, c = enmap.rbin(m, **kw)
		jv, jc = jenmap.rbin(jm, **kw)
		assert rel(v, jv) <= TOL and rel(c, jc) <= TOL
	assert rel(enmap.radial_average(m)[0], jenmap.radial_average(jm)[0]) <= TOL


def test_filters_and_derivatives():
	m, jm, x = maps()
	for got, want in [(enmap.smooth_gauss(m, 0.3*DEG), jenmap.smooth_gauss(jm, 0.3*DEG)),
			(enmap.apply_window(m), jenmap.apply_window(jm)),
			(enmap.apply_window(m, pow=2, order=1), jenmap.apply_window(jm, pow=2, order=1)),
			(enmap.unapply_window(m), jenmap.unapply_window(jm)),
			(enmap.rotate_pol(m, 0.3), jenmap.rotate_pol(jm, 0.3)),
			(enmap.rotate_pol(m, m[0], spin=1), jenmap.rotate_pol(jm, jm[0], spin=1)),
			(enmap.grad(m[0]), jenmap.grad(jm[0])), (enmap.grad(m), jenmap.grad(jm)),
			(enmap.grad_pix(m[0]), jenmap.grad_pix(jm[0])),
			(enmap.div(m[:2]), jenmap.div(jm[:2])), (enmap.laplace(m), jenmap.laplace(jm)),
			(enmap.shift(m, [3, -5]), jenmap.shift(jm, [3, -5])),
			(enmap.fractional_shift(m, [0.3, -1.4]), jenmap.fractional_shift(jm, [0.3, -1.4]))]:
		assert got.wcs.wcs.crpix.tolist() == want.wcs.wcs.crpix.tolist()
		assert rel(got, want) <= TOL
	assert enmap.smooth_gauss(m, 0).data.equal(m.data)
	assert enmap.smooth_gauss(m.astype(np.float32), 0.3*DEG).dtype == torch.float32
	for a, b in zip(enmap.calc_window(SHAPE, order=1), jenmap.calc_window(SHAPE, order=1)):
		np.testing.assert_array_equal(a, b)
	ps = np.random.default_rng(3).standard_normal((2, 200))**2
	for kw in (dict(), dict(kernel="step", width=5), dict(weight="uniform", width=3)):
		np.testing.assert_allclose(enmap.smooth_spectrum(ps, **kw), jenmap.smooth_spectrum(ps, **kw), rtol=1e-12)
	assert list(enmap.spin_helper([0, 2], 3)) == list(jenmap.spin_helper([0, 2], 3))
	assert list(enmap.spin_helper([0, 1, 2], 6)) == list(jenmap.spin_helper([0, 1, 2], 6))
	assert list(enmap.spin_pre_helper([0, 2], (2, 3))) == list(jenmap.spin_pre_helper([0, 2], (2, 3)))


def spectrum(n=3, nl=2000):
	l = np.arange(nl)
	cov = np.zeros((n, n, nl))
	for i in range(n): cov[i, i] = (1 + 0.5*i)/(l + 20.)**2
	cov[0, 1] = cov[1, 0] = 0.3/(l + 20.)**2
	return cov


@pytest.mark.parametrize("case", ["iqu", "scalar", "oned", "exp"])
def test_spec2flat_and_random_fields(case):
	"""spec2flat and the random fields from one seed give the reference's
	numbers."""
	(shape, w), (jshape, jw) = geo()
	cov = spectrum()
	if case == "iqu":
		assert rel(enmap.spec2flat(shape, w, cov, device="cpu"), jenmap.spec2flat(jshape, jw, cov)) == 0
		got = enmap.rand_map((3,) + shape, w, cov, seed=4, device="cpu")
		want = jenmap.rand_map((3,) + jshape, jw, cov, seed=4)
		assert rel(got, want) <= TOL
		got = enmap.rand_map((3,) + shape, w, cov, seed=4, iau=True, spin=[0, 1], device="cpu")
		assert rel(got, jenmap.rand_map((3,) + jshape, jw, cov, seed=4, iau=True, spin=[0, 1])) <= TOL
	elif case == "scalar":
		got = enmap.rand_map((3,) + shape, w, cov, seed=5, scalar=True, pixel_units=True, device="cpu")
		want = jenmap.rand_map((3,) + jshape, jw, cov, seed=5, scalar=True, pixel_units=True)
		assert rel(got, want) <= TOL
		assert rel(enmap.rand_gauss(shape, w, seed=1, device="cpu"), jenmap.rand_gauss(jshape, jw, seed=1)) == 0
		assert rel(enmap.rand_gauss_harm(shape, w, seed=1, device="cpu"),
			jenmap.rand_gauss_harm(jshape, jw, seed=1)) == 0
	elif case == "oned":
		c1 = cov[0, 0, :40]   # shorter than the largest |l|: zero past the end
		assert rel(enmap.spec2flat(shape, w, c1, device="cpu"), jenmap.spec2flat(jshape, jw, c1)) == 0
		assert rel(enmap.rand_map(shape, w, cov[0, 0], seed=6, device="cpu"),
			jenmap.rand_map(jshape, jw, cov[0, 0], seed=6)) <= TOL
		assert rel(enmap.rand_gauss_iso_harm(shape, w, cov[0, 0], seed=6, device="cpu"),
			jenmap.rand_gauss_iso_harm(jshape, jw, cov[0, 0], seed=6)) <= TOL
	else:
		assert rel(enmap.spec2flat(shape, w, cov, exp=0.5, device="cpu"),
			jenmap.spec2flat(jshape, jw, cov, exp=0.5)) <= TOL
		assert rel(enmap.multi_pow(cov, -1), jenmap.multi_pow(cov, -1)) <= TOL
		np.testing.assert_array_equal(enmap.massage_spectrum(cov, (2,) + shape),
			jenmap.massage_spectrum(cov, (2,) + shape))
		np.testing.assert_array_equal(enmap.massage_spectrum(cov[0, 0], (3,) + shape),
			jenmap.massage_spectrum(cov[0, 0], (3,) + shape))


def test_tables_built_once(monkeypatch):
	"""map2harm / harm2map / lbin / spec2flat build nothing map-sized on the
	host: the l axes are computed and copied to the device once per
	geometry, and a repeated call builds none of them again."""
	m, _, x = maps(seed=7)
	calls = []
	laxes = enmap.laxes
	monkeypatch.setattr(enmap, "laxes", lambda *a, **k: calls.append(a[0]) or laxes(*a, **k))
	enmap._laxes_on.cache_clear()
	enmap._laxes_np.cache_clear()
	first = enmap.lbin(enmap.calc_ps2d(enmap.map2harm(m, iau=True)))[0]
	misses = enmap._laxes_on.cache_info().misses
	assert calls == [SHAPE] and misses == 1
	for _ in range(2):
		h = enmap.map2harm(m, iau=True)
		again = enmap.lbin(enmap.calc_ps2d(h))[0]
		enmap.harm2map(h, iau=True)
		enmap.spec2flat(m.shape, m.wcs, spectrum(), device="cpu")
		enmap.smooth_gauss(m, 0.1*DEG)
	assert calls == [SHAPE] and enmap._laxes_on.cache_info().misses == misses
	assert torch.equal(first, again)
	# a new geometry builds its own
	enmap.map2harm(m[..., 1:, :])
	assert len(calls) == 2


def test_entry_points_default_to_cuda():
	"""With no device argument the new map-making entry points allocate on
	CUDA; without a CUDA device they raise and never return a CPU tensor."""
	(shape, w), _ = geo()
	cov = spectrum()
	calls = [lambda: enmap.ones(shape, w), lambda: enmap.full(shape, w, 1.0),
		lambda: enmap.enmap(np.ones(shape), w), lambda: enmap.lmap(shape, w), lambda: enmap.modlmap(shape, w),
		lambda: enmap.lrmap(shape, w), lambda: enmap.modrmap(shape, w), lambda: enmap.pixmap(shape, w),
		lambda: enmap.spec2flat(shape, w, cov), lambda: enmap.rand_map((3,) + shape, w, cov, seed=0),
		lambda: enmap.rand_gauss(shape, w, seed=0), lambda: enmap.queb_rotmat(np.zeros((2,) + shape)),
		lambda: enmap.pixshapemap(shape, w), lambda: enmap.pixsizemap_contour(shape, w)]
	for call in calls:
		if torch.cuda.is_available():
			assert call().device.type == "cuda"
		else:
			with pytest.raises((AssertionError, RuntimeError)):
				call()
