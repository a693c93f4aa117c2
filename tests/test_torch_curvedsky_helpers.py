"""The 2d/cyl entry points and helpers of pixell_tpu_torch.curvedsky and sht
that need no kernel, each against its pixell_tpu counterpart on the same
numpy inputs, in float64 on the CPU: get_method, quad_weights, filter,
transfer_alm (whose identity shortcut must return a tensor that does not
alias its input), alm_info.get_map / transpose_alm, alm_complex2real /
alm_real2complex, the ring infos, pad_spectrum / prepare_ps, the profile
transforms, jacobi_inverse / minres_inverse, get_ducc_geo /
get_ducc_maxlmax, prepare_raw, the flip and pad helpers, the per-method
entry points, and sht's accuracy, adjoint_analysis, _torus_extend and
resample_theta.

Tolerances: exact where both sides do the same host arithmetic; 1e-10 of
the largest reference value where a transform runs (1e-8 for minres, whose
iterations amplify the rounding of each side's products).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky, sht as jsht
from pixell_tpu_torch import enmap, curvedsky, sht, powspec, wcsutils

LMAX = 12
SHAPE = (20, 40)


def port_wcs(w):
	return wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)


def geometries():
	"""{name: (shape, reference wcs, port wcs)}: full-sky Fejer-1 and CC, a
	band with y padding, a cyl geometry and a map with both axes flipped."""
	out = {}
	shape, jwcs = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	out["F1"] = (shape, jwcs)
	out["CC"] = jenmap.fullsky_geometry(shape=(SHAPE[0] + 1, SHAPE[1]), variant="cc")
	out["band"] = jenmap.slice_geometry(shape, jwcs, (slice(4, 15), slice(None)))
	cyl = jwcs.deepcopy()
	cyl.wcs.crpix = np.array(cyl.wcs.crpix) + [0, 0.3]
	out["cyl"] = (shape, cyl)
	flipped = jwcs.deepcopy()
	flipped.wcs.cdelt = -np.array(flipped.wcs.cdelt)
	out["flipped"] = (shape, flipped)
	return {k: (tuple(s), w, port_wcs(w)) for k, (s, w) in out.items()}


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def rand_alm(lmax, pre=(), seed=0, mmax=None):
	n = curvedsky.alm_info(lmax=lmax, mmax=mmax).nelem
	rng = np.random.default_rng(seed)
	return rng.standard_normal(pre + (n,)) + 1j*rng.standard_normal(pre + (n,))


def test_geometry_helpers():
	for name, (shape, jwcs, wcs) in geometries().items():
		assert curvedsky.get_method(shape, wcs) == jcurvedsky.get_method(shape, jwcs), name
		geo, jgeo = curvedsky.get_ducc_geo(wcs, shape), jcurvedsky.get_ducc_geo(jwcs, shape)
		assert (geo is None) == (jgeo is None), name
		if geo is not None:
			assert (geo.name, geo.phi0) == (jgeo.name, jgeo.phi0)
		if jcurvedsky.get_method(shape, jwcs) == "2d":
			np.testing.assert_array_equal(curvedsky.quad_weights(shape, wcs),
				jcurvedsky.quad_weights(shape, jwcs))
		else:
			with pytest.raises(ValueError):
				curvedsky.quad_weights(shape, wcs)
		info, jinfo = curvedsky.get_ring_info(shape, wcs), jcurvedsky.get_ring_info(shape, jwcs)
		for key in ("theta", "nphi", "phi0"):
			np.testing.assert_array_equal(info[key], jinfo[key])
		assert info.nring == jinfo.nring
		lim = curvedsky.apply_minfo_theta_lim(info, 0.5, 2.5)
		jlim = jcurvedsky.apply_minfo_theta_lim(jinfo, 0.5, 2.5)
		for key in ("theta", "nphi", "phi0"):
			np.testing.assert_array_equal(lim[key], jlim[key])
		assert curvedsky.apply_minfo_theta_lim(info) is info
	theta = np.linspace(0.1, 3.0, 7)
	assert curvedsky.get_ring_info(theta).nring == 7
	r, jr = curvedsky.get_ring_info_radial(theta), jcurvedsky.get_ring_info_radial(theta)
	for key in ("theta", "nphi", "phi0", "offsets", "stride"):
		np.testing.assert_array_equal(r[key], jr[key])
		assert r[key].dtype == jr[key].dtype
	assert (r.npix, r.nrow) == (jr.npix, jr.nrow)
	for name in ("CC", "DH", "F2", "F1", "MW"):
		assert curvedsky.get_ducc_maxlmax(name, 21) == jcurvedsky.get_ducc_maxlmax(name, 21)
	assert curvedsky.dangerous_dtype(np.dtype(">f8")) and not curvedsky.dangerous_dtype(np.float32)
	assert not curvedsky.dangerous_dtype(torch.float32)
	assert issubclass(curvedsky.ShapeError, ValueError)


def test_filter():
	shape, jwcs, wcs = geometries()["F1"]
	m = np.asarray(jcurvedsky.alm2map(rand_alm(LMAX, seed=1), jenmap.zeros(shape, jwcs), spin=[0]))
	fl = np.exp(-np.arange(LMAX + 1)/5.0)
	want = np.asarray(jcurvedsky.filter(jenmap.ndmap(m, jwcs), fl, lmax=LMAX))
	got = curvedsky.filter(enmap.ndmap(torch.from_numpy(m.copy()), wcs), fl, lmax=LMAX)
	assert got.shape == shape and rel(got.data, want) <= 1e-10
	got = curvedsky.filter(enmap.ndmap(torch.from_numpy(m.copy()), wcs),
		lambda l: np.exp(-l/5.0), lmax=LMAX)
	assert rel(got.data, want) <= 1e-10


def test_transfer_alm():
	a = rand_alm(LMAX, (2,), seed=2)
	ta = torch.from_numpy(a)
	i = curvedsky.alm_info(lmax=LMAX)
	# the identity shortcut: equal values, no aliasing
	same = curvedsky.transfer_alm(i, ta, curvedsky.alm_info(lmax=LMAX))
	assert torch.equal(same, ta) and same.data_ptr() != ta.data_ptr()
	same[0, 0] = 99
	assert ta[0, 0] != 99
	for o in (curvedsky.alm_info(lmax=LMAX + 4), curvedsky.alm_info(lmax=LMAX - 3),
			curvedsky.alm_info(lmax=LMAX, mmax=5), curvedsky.alm_info(lmax=LMAX + 2, layout="rect")):
		want = np.asarray(jcurvedsky.transfer_alm(i, a, o))
		np.testing.assert_array_equal(curvedsky.transfer_alm(i, ta, o).numpy(), want)
		# into a given out, with an op
		out = rand_alm(o.lmax, (2,), seed=3, mmax=o.mmax) if o._is_tri() else \
			np.random.default_rng(3).standard_normal((2, o.nelem)) + 0j
		add = lambda x, y: x + y
		want = np.asarray(jcurvedsky.transfer_alm(i, a, o, out=out, op=add))
		tout = torch.from_numpy(out.copy())
		got = curvedsky.transfer_alm(i, ta, o, out=tout, op=add)
		assert got is tout and rel(got, want) <= 1e-15


def test_alm_info_maps_and_real_layout():
	for info in (curvedsky.alm_info(lmax=LMAX), curvedsky.alm_info(lmax=LMAX, mmax=7),
			curvedsky.alm_info(lmax=LMAX, layout="rect")):
		jinfo = jcurvedsky.alm_info(lmax=info.lmax, mmax=info.mmax,
			layout="rect" if not info._is_tri() else "triangular")
		np.testing.assert_array_equal(info.get_map(), jinfo.get_map())
		a = np.random.default_rng(4).standard_normal((3, info.nelem)) + 0j
		a.imag = np.random.default_rng(5).standard_normal(a.shape)
		want = np.asarray(jinfo.transpose_alm(a))
		np.testing.assert_array_equal(info.transpose_alm(torch.from_numpy(a)).numpy(), want)
		out = torch.zeros(want.shape, dtype=torch.complex128)
		assert info.transpose_alm(torch.from_numpy(a), out) is out
		np.testing.assert_array_equal(out.numpy(), want)
	a = rand_alm(LMAX, (3,), seed=6)
	ainfo = curvedsky.alm_info(lmax=LMAX)
	r = curvedsky.alm_complex2real(torch.from_numpy(a), ainfo)
	np.testing.assert_array_equal(r.numpy(), jcurvedsky.alm_complex2real(a, ainfo))
	back = curvedsky.alm_real2complex(r)
	np.testing.assert_allclose(back.numpy(), jcurvedsky.alm_real2complex(r.numpy()), rtol=0, atol=1e-15)
	a0 = a.copy()
	a0[:, :LMAX + 1] = a0[:, :LMAX + 1].real   # m = 0 is real in the real layout
	assert rel(curvedsky.alm_real2complex(curvedsky.alm_complex2real(torch.from_numpy(a0))), a0) <= 1e-15


def test_spectra():
	ps1 = np.arange(1, 8.0)
	ps2 = np.random.default_rng(7).uniform(1, 2, (6, 8))
	ps3 = np.random.default_rng(8).uniform(1, 2, (3, 3, 8))
	for lmax in (4, 7, 11):
		np.testing.assert_array_equal(curvedsky.pad_spectrum(ps2, lmax), jcurvedsky.pad_spectrum(ps2, lmax))
	for ps in (ps1, ps2, ps3):
		for kw in (dict(), dict(lmax=11), dict(ainfo=curvedsky.alm_info(lmax=5))):
			wps, info = curvedsky.prepare_ps(ps, **kw)
			jwps, jinfo = jcurvedsky.prepare_ps(ps, **kw)
			np.testing.assert_array_equal(wps, jwps)
			assert (info.lmax, info.mmax) == (jinfo.lmax, jinfo.mmax)
	from pixell_tpu import powspec as jpowspec
	for scheme in (None, "diag"):
		np.testing.assert_array_equal(powspec.sym_expand(ps2, scheme=scheme),
			jpowspec.sym_expand(ps2, scheme=scheme))


def test_profiles():
	r = np.linspace(0, 0.3, 50)
	br = np.exp(-(r/0.05)**2)
	for kw in (dict(), dict(lmax=40, oversample=2)):
		bl = curvedsky.profile2harm(br, r, **kw)
		assert rel(bl, jcurvedsky.profile2harm(br, r, **kw)) <= 1e-14
		assert rel(curvedsky.harm2profile(bl, r), jcurvedsky.harm2profile(bl, r)) <= 1e-14
	x = np.linspace(-1, 1, 9)
	np.testing.assert_array_equal(curvedsky._legendre_p(10, x), jcurvedsky._legendre_p(10, x))


def test_inverses():
	"""x from y = forward(x) for a linear forward on tensors, by Jacobi and
	by Minres on the normal equations, against the reference on numpy."""
	rng = np.random.default_rng(9)
	M = np.eye(30) + 0.1*rng.standard_normal((30, 30))
	# Jacobi: an approximate inverse; Minres: the transpose, so that
	# approx_backward(forward(.)) is symmetric, as Minres needs
	B = np.linalg.inv(M) + 0.01*rng.standard_normal((30, 30))
	x = rng.standard_normal((3, 10))
	y = (M @ x.reshape(-1)).reshape(3, 10)
	fwd = lambda v: (torch.from_numpy(M) @ v.reshape(-1)).reshape(3, 10)
	back = lambda v: (torch.from_numpy(B) @ v.reshape(-1)).reshape(3, 10)
	jfwd = lambda v: (M @ np.asarray(v).reshape(-1)).reshape(3, 10)
	jback = lambda v: (B @ np.asarray(v).reshape(-1)).reshape(3, 10)
	ty = torch.from_numpy(y)
	got = curvedsky.jacobi_inverse(fwd, back, ty, niter=3)
	assert rel(got, jcurvedsky.jacobi_inverse(jfwd, jback, y, niter=3)) <= 1e-13
	back = lambda v: (torch.from_numpy(M.T.copy()) @ v.reshape(-1)).reshape(3, 10)
	jback = lambda v: (M.T @ np.asarray(v).reshape(-1)).reshape(3, 10)
	got = curvedsky.minres_inverse(fwd, back, ty, epsilon=1e-12, maxiter=60)
	want = jcurvedsky.minres_inverse(jfwd, jback, y, epsilon=1e-12, maxiter=60)
	assert isinstance(got, torch.Tensor) and got.shape == (3, 10)
	assert rel(got, want) <= 1e-8 and rel(got, x) <= 1e-8


def test_flip_and_pad_helpers():
	shape, jwcs, wcs = geometries()["F1"]
	m = np.random.default_rng(10).standard_normal((3,) + shape)
	jm, tm = jenmap.ndmap(m, jwcs), enmap.ndmap(torch.from_numpy(m.copy()), wcs)
	pad = np.array([[2, 3], [1, 4]])
	for flips in ([False, False], [True, False], [True, True], [False, True]):
		assert curvedsky.flip2slice(flips) == jcurvedsky.flip2slice(flips)
		gs, gw = curvedsky.flip_geometry(shape, wcs, flips)
		js, jw = jcurvedsky.flip_geometry(shape, jwcs, flips)
		assert tuple(gs) == tuple(js)
		np.testing.assert_allclose(gw.wcs.crpix, jw.wcs.crpix)
		np.testing.assert_allclose(gw.wcs.cdelt, jw.wcs.cdelt)
		np.testing.assert_array_equal(curvedsky.flip_array(tm, flips).data.numpy(),
			np.asarray(jcurvedsky.flip_array(jm, flips)))
		buf, jbuf = curvedsky.map2buffer(tm, flips, pad), jcurvedsky.map2buffer(jm, flips, pad)
		assert buf.shape == tuple(jbuf.shape)
		np.testing.assert_array_equal(buf.data.numpy(), np.asarray(jbuf))
		np.testing.assert_allclose(buf.wcs.wcs.crpix, jbuf.wcs.wcs.crpix)
		assert bool((curvedsky.map2buffer(tm, flips, pad, obuf=True).data == 0).all())
		back = curvedsky.buffer2map(buf, flips, pad)
		np.testing.assert_array_equal(back.data.numpy(), m)
		np.testing.assert_allclose(back.wcs.wcs.crpix, wcs.wcs.crpix)
	ps, pw = curvedsky.pad_geometry(shape, wcs, pad)
	js, jw = jcurvedsky.pad_geometry(shape, jwcs, pad)
	assert tuple(ps) == tuple(js)
	np.testing.assert_allclose(pw.wcs.crpix, jw.wcs.crpix)


def test_per_method_entry_points():
	"""The *_2d / *_cyl / *_raw_* routers give what alm2map and map2alm give;
	the raw "general" ones what synthesis_general and
	adjoint_synthesis_general give at the pixels' positions."""
	geos = geometries()
	a = torch.from_numpy(rand_alm(LMAX, (3,), seed=12))
	for name, synth, anal, rsynth, ranal in (
			("F1", curvedsky.alm2map_2d, curvedsky.map2alm_2d, curvedsky.alm2map_raw_2d,
				curvedsky.map2alm_raw_2d),
			("cyl", curvedsky.alm2map_cyl, curvedsky.map2alm_cyl, curvedsky.alm2map_raw_cyl,
				curvedsky.map2alm_raw_cyl)):
		shape, _, wcs = geos[name]
		zeros = lambda: enmap.zeros((3,) + shape, wcs, device="cpu")
		want = curvedsky.alm2map(a, zeros())
		assert torch.equal(synth(a, zeros()).data, want.data)
		assert torch.equal(rsynth(a, zeros()).data, want.data)
		walm = curvedsky.map2alm(want, lmax=LMAX)
		assert torch.equal(anal(want, lmax=LMAX), walm)
		assert torch.equal(ranal(want, lmax=LMAX), walm)
		# adjoint=True through the routers
		assert torch.equal(synth(torch.zeros_like(a), want, adjoint=True),
			curvedsky.alm2map_adjoint(want, ainfo=curvedsky.alm_info(lmax=LMAX)))
		assert torch.equal(anal(zeros(), a, adjoint=True).data, curvedsky.map2alm_adjoint(a, zeros()).data)
	shape, _, wcs = geos["F1"]
	loc = curvedsky.calc_locinfo(shape, wcs).loc
	want = curvedsky.synthesis_general(a, loc, lmax=LMAX, device="cpu")
	assert torch.equal(curvedsky.alm2map_raw_general(a, None, loc), want)
	m = curvedsky.alm2map_raw_general(a, enmap.zeros((3,) + shape, wcs, device="cpu"), loc)
	assert torch.equal(m.data, want.reshape((3,) + shape))
	assert torch.equal(curvedsky.map2alm_raw_general(m, loc, lmax=LMAX),
		curvedsky.adjoint_synthesis_general(want, loc, lmax=LMAX, device="cpu"))
	alm, m, info = curvedsky.prepare_raw(None, enmap.zeros((3,) + shape, wcs, device="cpu"), lmax=LMAX)
	jalm, _, jinfo = jcurvedsky.prepare_raw(None, np.zeros((3,) + shape), lmax=LMAX)
	assert alm.shape == jalm.shape and alm.device.type == "cpu" and info.nelem == jinfo.nelem
	_, _, info = curvedsky.prepare_raw(alm, None)
	assert info.lmax == LMAX


def test_sht_extras():
	shape, jwcs, wcs = geometries()["F1"]
	theta = np.asarray(jcurvedsky.analyse_geometry(shape, jwcs).theta)
	w = jsht.ring_weights("F1", shape[0])
	a = rand_alm(LMAX, (3,), seed=13)
	for spin in ([0, 2], [0, 3]):
		want = np.asarray(jsht.adjoint_analysis(a, theta, shape[1], w, phi0=0.1, lmax=LMAX, spin=spin))
		got = sht.adjoint_analysis(torch.from_numpy(a), theta, shape[1], w, phi0=0.1, lmax=LMAX, spin=spin)
		assert rel(got, want) <= 1e-10
	maps = np.asarray(jsht.synthesis(a, theta, shape[1], lmax=LMAX, spin=[0, 2]))
	cc = jsht.ring_theta("CC", 21)
	cmaps = np.asarray(jsht.synthesis(a, cc, shape[1], lmax=LMAX, spin=[0, 2]))
	for variant, m, nt in (("F1", maps, 31), ("F1", maps, 27), ("CC", cmaps, 30), ("CC", cmaps, 27)):
		m = m.copy()
		t, _ = sht._torus_extend(torch.from_numpy(m), variant, [0, 2, 2])
		jt, _ = jsht._torus_extend(m, variant, [0, 2, 2])
		assert rel(t, np.asarray(jt)) <= 1e-12
		got = sht.resample_theta(torch.from_numpy(m), variant, nt, [0, 2, 2])
		want = np.asarray(jsht.resample_theta(m, variant, nt, [0, 2, 2]))
		assert got.dtype == torch.float64 and rel(got, want) <= 1e-12
	# accuracy: None keeps the current mode; the mode is restored on exit
	assert not sht.ACCURACY_HIGH
	with sht.accuracy("high"):
		assert sht.ACCURACY_HIGH and sht._leg_dtype(torch.float32) == torch.float64
		with sht.accuracy(None):
			assert sht.ACCURACY_HIGH
		with sht.accuracy("fast"):
			assert sht._leg_dtype(torch.float32) == torch.float32
	assert not sht.ACCURACY_HIGH
	with pytest.raises(ValueError):
		with sht.accuracy("medium"): pass
