"""pixell_tpu_torch.interpol against pixell_tpu.interpol on the CPU in
float64, with inputs made from a numpy seed: two maps [2, 20, 33] (fewer
rows than the prefilter's 48-pixel pad, so the border pads wrap more than
once) at 40 points spread 5 pixels beyond every edge, so each reference
program compiles once:

- map_coordinates for every (mode, order, border) the reference's _KERNELS
  serves, values and deriv=True; 1d data forward, and its transpose by
  the dot product with the port's own 1d forward (the reference's 1d
  transpose raises); the transposes and spline_filter against the
  reference are in tests/test_torch_interpol_trans.py;
- adjointness <A x, y> = <x, A^T y> of the port in float64, the chunked
  gather against one chunk, exact reproduction at the nodes, the
  response table cached per (n, order, dtype, device);
- float32 data against the reference's float64 result: F32_TOL;
- build, ip_ndimage / ip_linear / ip_grad, lin_derivs_forward,
  grad_forward.

Tolerance: 1e-12 of the largest reference value in float64 (the port
takes the same taps and weights; the prefilter's division by the
response in rfft form instead of complex FFTs differs in the last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp

from pixell_tpu import interpol as jinterpol, resample as jresample, array_ops as jarray_ops, enmap as jenmap
from pixell_tpu_torch import interpol, resample, array_ops, enmap, utils

TOL = 1e-12
F32_TOL = 2e-5   # float32 data (spline gain up to ~3-8 at Nyquist) against the float64 reference
SHAPE = (2, 20, 33)
NPT = 40
BORDERS = ["cyclic", "nearest", "mirror", "zero"]
# (mode, order) pairs the reference serves: order 0 (nearest) before its
# table, orders 1-5 of "spline" and "conv", Lanczos-3
PAIRS = [("spline", o) for o in range(6)] + [("conv", o) for o in range(1, 6)] + [("lanczos", 3)]


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def data(seed=0, shape=SHAPE):
	return np.random.default_rng(seed).standard_normal(shape)


def points(seed=1, n=NPT, shape=SHAPE):
	rng = np.random.default_rng(seed)
	return np.stack([rng.uniform(-5, shape[-2] + 5, n), rng.uniform(-5, shape[-1] + 5, n)])


@pytest.mark.parametrize("mode,order", PAIRS)
@pytest.mark.parametrize("border", BORDERS)
def test_map_coordinates(mode, order, border):
	d, p = data(), points()
	for deriv in ([False] if mode == "lanczos" else [False, True]):
		want = jinterpol.map_coordinates(jnp.asarray(d), jnp.asarray(p), mode=mode, order=order, border=border,
			deriv=deriv)
		got = interpol.map_coordinates(torch.from_numpy(d), torch.from_numpy(p), mode=mode, order=order,
			border=border, deriv=deriv)
		assert rel(got, want) <= TOL, deriv


def dot(a, b): return float((a*b).sum())


@pytest.mark.parametrize("order", [0, 1, 3, 5])
@pytest.mark.parametrize("border", BORDERS)
def test_adjointness(order, border):
	"""<A x, y> = <x, A^T y> for the values and the gradient, in float64."""
	rng = np.random.default_rng(3)
	x, p = torch.from_numpy(data()), torch.from_numpy(points())
	for deriv in (False, True):
		y = torch.from_numpy(rng.standard_normal((2,) + ((2,) if deriv else ()) + (NPT,)))
		ax = interpol.map_coordinates(x, p, order=order, border=border, deriv=deriv)
		aty = interpol.map_coordinates(x, p, odata=y, order=order, border=border, deriv=deriv, trans=True)
		lhs, r = dot(ax, y), dot(x, aty)
		assert abs(lhs - r) <= 1e-12*max(abs(lhs), abs(r), 1), deriv


def test_1d():
	"""1d data: the forward against the reference; the transpose (the
	reference's raises: it lifts the points but not the data) by the dot
	product with the port's own 1d forward."""
	rng = np.random.default_rng(4)
	d = rng.standard_normal((2, 30))
	p = rng.uniform(-3, 33, (1, 7))
	for order, border in [(1, "nearest"), (3, "cyclic"), (3, "zero")]:
		want = jinterpol.map_coordinates(jnp.asarray(d), jnp.asarray(p), order=order, border=border)
		got = interpol.map_coordinates(torch.from_numpy(d), torch.from_numpy(p), order=order, border=border)
		assert rel(got, want) <= TOL
		y = torch.from_numpy(rng.standard_normal((2, 7)))
		aty = interpol.map_coordinates(torch.from_numpy(d), torch.from_numpy(p), odata=y, order=order,
			border=border, trans=True)
		assert aty.shape == d.shape
		lhs, r = dot(got, y), dot(torch.from_numpy(d), aty)
		assert abs(lhs - r) <= 1e-12*max(abs(lhs), abs(r))
	with pytest.raises(ValueError):
		jinterpol.map_coordinates(jnp.arange(20.), jnp.ones((1, 7)), odata=jnp.ones(7), trans=True)


def test_exact_at_nodes_and_chunks(monkeypatch):
	"""Order 3 splines reproduce the data at the pixel centres, everywhere
	in the cyclic, mirror and zero borders and two pixels in from the edge
	in the nearest one (its taps past the edge read the edge coefficient,
	not the coefficient the padded prefilter made there, as in the
	reference); the gather in chunks of 7 points gives what one chunk
	gives."""
	d = torch.from_numpy(data())
	iy, ix = np.mgrid[:SHAPE[-2], :SHAPE[-1]]
	p = torch.from_numpy(np.stack([iy.ravel(), ix.ravel()]).astype(float))
	for border in BORDERS:
		got = interpol.map_coordinates(d, p, order=3, border=border).reshape(d.shape)
		inner = (Ellipsis, slice(2, -2), slice(2, -2)) if border == "nearest" else Ellipsis
		assert rel(got[inner], d.numpy()[inner]) <= TOL, border
	p = torch.from_numpy(points())
	whole = interpol.map_coordinates(d, p, order=3, border="zero", deriv=True)
	v = torch.from_numpy(np.random.default_rng(5).standard_normal((2, NPT)))
	twhole = interpol.map_coordinates(d, p, odata=v, order=3, border="zero", trans=True)
	monkeypatch.setattr(interpol, "CHUNK", 7)
	assert rel(interpol.map_coordinates(d, p, order=3, border="zero", deriv=True), whole.numpy()) == 0
	assert rel(interpol.map_coordinates(d, p, odata=v, order=3, border="zero", trans=True), twhole.numpy()) <= TOL


def test_response_cached():
	"""The response table is built on the host once per (n, order, dtype,
	device) and reused."""
	interpol._response_on.cache_clear()
	d = torch.from_numpy(data())
	for _ in range(3): interpol.spline_filter(d, order=3, axes=(-2, -1), border="cyclic")
	info = interpol._response_on.cache_info()
	assert info.misses == 2 and info.hits == 4   # the two axes' lengths
	np.testing.assert_array_equal(interpol._bspline_response(33, np.float64, 5),
		jinterpol._bspline_response(33, np.float64, order=5))


@pytest.mark.parametrize("order,border", [(3, "zero"), (3, "cyclic"), (5, "mirror"), (1, "nearest")])
def test_float32(order, border):
	"""float32 data and float64 positions: a float32 result within F32_TOL
	of the reference's float64 one (the prefilter's gain amplifies the
	float32 rounding: up to 3x for cubic splines at Nyquist)."""
	d, p = data(), points()
	want = jinterpol.map_coordinates(jnp.asarray(d), jnp.asarray(p), order=order, border=border)
	got = interpol.map_coordinates(torch.from_numpy(d).float(), torch.from_numpy(p), order=order, border=border)
	assert got.dtype == torch.float32
	assert rel(got.double(), want) <= F32_TOL


def test_interpolators():
	"""build with ip_linear / ip_grad, ip_ndimage on a grid, and the
	forward differences, against the reference."""
	box = np.array([[0.0, -1.0], [2.0, 1.5]])
	func = lambda x: np.array([np.sin(x[0])*np.cos(x[1]), x[0]*x[1]**2])
	rng = np.random.default_rng(6)
	x = np.stack([rng.uniform(0, 2, 25), rng.uniform(-1, 1.5, 25)])
	for ip in ["ip_linear", "ip_grad"]:
		got = interpol.build(func, getattr(interpol, ip), box, 1e-3)(x)
		want = jinterpol.build(func, getattr(jinterpol, ip), box, 1e-3)(x)
		assert rel(got, want) <= TOL, ip
	y = func(interpol._grid_coords(box, np.array([20, 33]))).reshape(2, 20, 33)
	got = interpol.ip_ndimage(box, y, order=3, border="nearest")(x)
	want = jinterpol.ip_ndimage(box, y, order=3, border="nearest")(x)
	assert isinstance(got, np.ndarray) and rel(got, want) <= TOL
	y = rng.standard_normal((3, 6, 7))
	assert rel(interpol.lin_derivs_forward(y, 1), jinterpol.lin_derivs_forward(y, 1)) == 0
	assert rel(interpol.grad_forward(y, 1), jinterpol.grad_forward(y, 1)) == 0
	assert interpol.get_core(np.float32) is interpol.map_coordinates
