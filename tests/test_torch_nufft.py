"""The ES-kernel NUFFT of pixell_tpu_torch.fft and the plain twins of its
point-stage kernels (ops.nufft_core, which the CPU runs in place of K10 and
K11), in float64 on the CPU, with inputs made from a numpy seed:

- u2nu, nu2u (both conventions, FFT and centred order, odd and even
  sizes), u2nu_plan (complex and real output, normalized) and
  interpol_nufft against pixell_tpu.fft, within 1e-10 of the largest
  reference value, on the reference's own cases
  (tests/test_harmonic_services.py:139-199, tests/test_interpol.py);
- u2nu and nu2u against a direct Fourier sum (1e-9: the ES kernel's
  epsilon 1e-10);
- nu2u as the transpose of u2nu, and the real-output fine-grid build
  against its written-out transpose, within 1e-10 relative at even sizes,
  where the zero-pad's Nyquist bin is split and its transpose halves it;
- the twins' chunking, the float64 position split, the wrappers' argument
  checks, and the kernel width the CUDA source takes.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from pixell_tpu import fft as jfft, enmap as jenmap, wcsutils as jwcsutils
from pixell_tpu_torch import fft, enmap, wcsutils
from pixell_tpu_torch.ops import nufft_core, nufft_cuda

SHAPES = {"odd": (9, 9), "even": (16, 24)}


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def cgrid(rng, shape):
	return rng.standard_normal(shape) + 1j*rng.standard_normal(shape)


def points(rng, n):
	"""n points, some outside one period and on its edges."""
	pts = rng.uniform(-1, 2*np.pi + 1, (n, 2))
	pts[:3, 0] = [0.0, 2*np.pi, -1e-300]
	return pts


@pytest.mark.parametrize("size", SHAPES)
@pytest.mark.parametrize("forward,fft_order", [(False, True), (True, True), (False, False),
	(True, False)])
def test_u2nu_nu2u_against_reference(size, forward, fft_order):
	rng = np.random.default_rng(0)
	shape = SHAPES[size]
	g, pts, v = cgrid(rng, (2,) + shape), points(rng, 101), cgrid(rng, (2, 101))
	want = np.asarray(jfft.u2nu(jnp.asarray(g), jnp.asarray(pts), forward=forward, fft_order=fft_order))
	got = fft.u2nu(torch.from_numpy(g), torch.from_numpy(pts), forward=forward, fft_order=fft_order)
	assert rel(got, want) < 1e-10
	want = np.asarray(jfft.nu2u(jnp.asarray(v), jnp.asarray(pts), oshape=shape, forward=forward,
		fft_order=fft_order))
	got = fft.nu2u(torch.from_numpy(v), torch.from_numpy(pts), oshape=shape, forward=forward,
		fft_order=fft_order)
	assert rel(got, want) < 1e-10


def direct(shape, pts, sign):
	"""exp(sign i (ky y + kx x)) [npt, ny, nx] over the FFT-order
	frequencies; an even length's Nyquist frequency n/2 stands for +-n/2
	alike, as the zero-pad that splits it makes it: cos(n/2 y)."""
	def axis(n, x):
		k = np.fft.fftfreq(n)*n
		f = np.exp(sign*1j*k[None, :]*x[:, None])
		if n % 2 == 0: f[:, n//2] = np.cos(n//2*x)
		return f
	return axis(shape[0], pts[:, 0])[:, :, None]*axis(shape[1], pts[:, 1])[:, None, :]


@pytest.mark.parametrize("size", SHAPES)
def test_against_direct_sum(size):
	"""The reference's own case (test_nufft_inverse_pair): nu2u against the
	direct type-1 sum, and u2nu against the direct type-2 sum."""
	rng = np.random.default_rng(0)
	shape = SHAPES[size]
	pts = rng.uniform(0, 2*np.pi, (300, 2))
	v = rng.standard_normal(300) + 1j*rng.standard_normal(300)
	ref = np.einsum("p,pyx->yx", v, direct(shape, pts, -1))
	assert rel(fft.nu2u(torch.from_numpy(v), torch.from_numpy(pts), oshape=shape), ref) < 1e-9
	g = cgrid(rng, shape)
	ref = np.einsum("yx,pyx->p", g, direct(shape, pts, +1))
	assert rel(fft.u2nu(torch.from_numpy(g), torch.from_numpy(pts)), ref) < 1e-9


@pytest.mark.parametrize("shape", [(16, 24), (12, 18), (9, 10)])
@pytest.mark.parametrize("forward", [True, False])
def test_nu2u_is_the_transpose_of_u2nu(shape, forward):
	"""sum u2nu(g) v = sum g nu2u(v) (the transpose, not the conjugate
	transpose), in FFT and in centred order."""
	rng = np.random.default_rng(1)
	g, pts, v = cgrid(rng, shape), points(rng, 77), cgrid(rng, 77)
	for fft_order in (True, False):
		a = fft.u2nu(torch.from_numpy(g), torch.from_numpy(pts), forward=forward, fft_order=fft_order)
		b = fft.nu2u(torch.from_numpy(v), torch.from_numpy(pts), oshape=shape, forward=forward,
			fft_order=fft_order)
		lhs, rhs = np.sum(a.numpy()*v), np.sum(g*b.numpy())
		assert abs(lhs - rhs) < 1e-10*abs(lhs)


@pytest.mark.parametrize("shape", [(16, 24), (9, 10)])
def test_real_fine_build_adjoint(shape):
	"""_u2nu_fine_t with forward=True is the transpose over real and
	imaginary parts of the real-output fine-grid build with forward=False:
	sum fine(g) R = sum Re g Re G + Im g Im G."""
	rng = np.random.default_rng(2)
	g = torch.from_numpy(cgrid(rng, shape))
	fine, nfine, w, beta = fft._u2nu_fine(g, 1e-10, False, True, real_out=True)
	R = torch.from_numpy(rng.standard_normal(nfine))
	G = fft._u2nu_fine_t(R, shape, w, beta, True, True)
	lhs = float((fine*R).sum())
	rhs = float((g.real*G.real).sum() + (g.imag*G.imag).sum())
	assert abs(lhs - rhs) < 1e-10*abs(lhs)
	# the real-output build is the real part of the complex one
	full = fft._u2nu_fine(g, 1e-10, False, True)[0]
	assert rel(fine, full.real) < 1e-13


def test_u2nu_plan_against_reference():
	"""The reference's test_u2nu_plan: eval in grid units against direct
	u2nu, and the normalized real-output plan."""
	rng = np.random.default_rng(21)
	ny, nx = 16, 24
	g = cgrid(rng, (2, ny, nx))
	iy, ix = rng.uniform(0, ny, 37), rng.uniform(0, nx, 37)
	for cplx in (True, False):
		for norm in (False, True):
			jp = jfft.u2nu_plan(jnp.asarray(g), axes=(-2, -1), epsilon=1e-10, normalize=norm, complex=cplx)
			pp = fft.u2nu_plan(torch.from_numpy(g), axes=(-2, -1), epsilon=1e-10, normalize=norm,
				complex=cplx)
			want = np.asarray(jp.eval(np.array([iy, ix])))
			got = pp.eval(torch.from_numpy(np.array([iy, ix])))
			assert got.shape == (2, 37) and got.is_complex() == cplx
			assert rel(got, want) < 1e-10
	# other axes: the transform axes are moved last
	gt = np.moveaxis(g, 0, -1)
	pp = fft.u2nu_plan(torch.from_numpy(gt), axes=(0, 1), epsilon=1e-10)
	want = fft.u2nu_plan(torch.from_numpy(g), axes=(-2, -1), epsilon=1e-10).eval(np.array([iy, ix]))
	assert rel(pp.eval(np.array([iy, ix])), want) < 1e-14


def test_interpol_nufft():
	"""Against the reference, exact at the pixel centres, and a band-limited
	signal anywhere (tests/test_interpol.py)."""
	rng = np.random.default_rng(11)
	m = rng.standard_normal((16, 32))
	pos = np.array([rng.uniform(-3, 19, 50), rng.uniform(-3, 35, 50)])
	want = np.asarray(jfft.interpol_nufft(m, pos))
	got = fft.interpol_nufft(torch.from_numpy(m), torch.from_numpy(pos))
	assert got.dtype == torch.float64 and rel(got, want) < 1e-10
	iy, ix = np.mgrid[:16, :32]
	got = fft.interpol_nufft(torch.from_numpy(m), np.array([iy.ravel()*1.0, ix.ravel()*1.0]),
		device="cpu")
	assert np.allclose(got.numpy(), m.ravel(), atol=1e-9)
	n = 32
	f = lambda y, x: np.cos(2*np.pi*3*y/n)*np.sin(2*np.pi*5*x/n + 0.3)
	x = np.arange(n)
	pos = np.array([[3.3, 7.7], [10.123, 20.456]]).T
	got = fft.interpol_nufft(torch.from_numpy(f(x[:, None], x[None, :])), torch.from_numpy(pos))
	assert np.allclose(got.numpy(), f(pos[0], pos[1]), atol=1e-9)


def test_twin_chunking(monkeypatch):
	"""The twins' chunked passes over the points give the same numbers as
	one pass (the reference's test_u2nu_gather_chunking)."""
	rng = np.random.default_rng(3)
	fine = torch.from_numpy(cgrid(rng, (2, 30, 36)))
	co = torch.from_numpy(points(rng, 101))
	per = (2*np.pi, 2*np.pi)
	want = nufft_core.u2nu_points_plain(fine, co, per, 7, 16.1)
	spread = nufft_core.nu2u_spread_plain(want, co, (30, 36), per, 7, 16.1)
	monkeypatch.setattr(nufft_core, "GATHER_ELEMS", 2*2*49*16)
	assert torch.equal(nufft_core.u2nu_points_plain(fine, co, per, 7, 16.1), want)
	assert rel(nufft_core.nu2u_spread_plain(want, co, (30, 36), per, 7, 16.1), spread) < 1e-15


def test_position_split():
	"""The base and fraction of a point, in float64 whatever the working
	dtype: base + fraction is the position, the fraction in [0, 1), and
	the float32 weights come from the fraction cast, not from a float32
	position (which on an 8064-wide grid would be off by ~5e-4 pixels)."""
	n = 8064
	c = torch.tensor([[2*np.pi - 1e-9, 1e-9], [3.0000001, 6.2], [-1e-300, 4*np.pi + 0.5]],
		dtype=torch.float64)
	(by, fy), (bx, fx) = nufft_core.split_positions(c, (n, n), (2*np.pi, 2*np.pi))
	for b, f, col in ((by, fy, 0), (bx, fx, 1)):
		p = torch.remainder(c[:, col]/(2*np.pi), 1.0)*n
		assert torch.equal(b.double() + f, p)
		assert bool(((f >= 0) & (f <= 1)).all())
	idx, wt32 = nufft_core.taps(by, fy, 7, 16.1, n, torch.float32)
	_, wt64 = nufft_core.taps(by, fy, 7, 16.1, n, torch.float64)
	assert bool((idx >= 0).all() and (idx < n).all())
	assert float((wt32.double() - wt64).abs().max()) < 1e-6


def test_wrappers_check_their_arguments():
	fine = torch.zeros(1, 20, 20)
	co = torch.zeros(5, 2, dtype=torch.float64)
	with pytest.raises(ValueError):
		nufft_cuda.u2nu_points(fine, co, (1.0, 1.0), 17, 30.0)
	with pytest.raises(ValueError):
		nufft_cuda.u2nu_points(fine, co.float(), (1.0, 1.0), 7, 16.1)
	with pytest.raises(ValueError):
		nufft_cuda.nu2u_spread(torch.zeros(1, 4), co, (20, 20), (1.0, 1.0), 7, 16.1)
	with pytest.raises(TypeError):
		nufft_cuda.u2nu_points(fine.half(), co, (1.0, 1.0), 7, 16.1)
	with pytest.raises(RuntimeError):
		nufft_cuda.u2nu_points(fine.to("meta"), co.to("meta"), (1.0, 1.0), 7, 16.1)
	# the CPU runs the plain twin and counts no launch
	nufft_cuda.reset_launches()
	nufft_cuda.u2nu_points(fine, co, (1.0, 1.0), 7, 16.1)
	assert sum(nufft_cuda.LAUNCHES.values()) == 0


def test_kernel_width_matches_the_source():
	src = (Path(nufft_cuda.__file__).resolve().parent.parent/"csrc"/"nufft.cu").read_text()
	assert int(re.search(r"constexpr int WMAX = (\d+);", src).group(1)) == nufft_cuda.WMAX
	assert fft._es_params(1e-30)[0] == nufft_cuda.WMAX


def test_es_correction_and_params_match_reference():
	for eps in (1e-5, 1e-6, 1e-10, 1e-14):
		assert fft._es_params(eps) == jfft._es_params(eps)
	for n, w in ((64, 7), (90, 11)):
		beta = 2.3*w
		assert np.array_equal(fft._es_correction(n, w, beta, np.float64),
			np.asarray(jfft._es_correction(n, w, beta, np.float64)))


def port_wcs(w):
	return wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)


@pytest.mark.parametrize("geo", ["fejer1", "car_off", "plain"])
def test_posmap_pixsizemap(geo):
	"""enmap.posmap and pixsizemap against the reference on the geometries
	the port takes: full-sky CAR, CAR whose cdelt does not divide 360
	degrees, and a plain WCS."""
	shape, jwcs = jenmap.fullsky_geometry(shape=(20, 40), variant="fejer1")
	if geo == "car_off":
		jwcs = jwcs.deepcopy()
		jwcs.wcs.cdelt = np.array([-7.3, 7.3])
		jwcs.wcs.crpix = np.array([3.3, 5.1])
	elif geo == "plain":
		jwcs = jwcsutils.WCS(naxis=2)
		jwcs.wcs.cdelt = np.array([0.05, 0.04])
		jwcs.wcs.crpix = np.array([2.0, 3.0])
		jwcs.wcs.crval = np.array([1.0, 0.2])
	shape = (12, 17)
	pm = enmap.posmap(shape, port_wcs(jwcs), device="cpu")
	assert rel(pm.data, np.asarray(jenmap.posmap(shape, jwcs))) < 1e-15
	ps = enmap.pixsizemap(shape, port_wcs(jwcs), device="cpu")
	assert rel(ps.data, np.asarray(jenmap.pixsizemap(shape, jwcs))) < 1e-13
	assert enmap.pixsizemap(shape, port_wcs(jwcs), broadcastable=True, device="cpu").shape in [(12, 1),
		(1, 1)]
