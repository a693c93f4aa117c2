"""pixell_tpu_torch.interpol.spline_filter, forward and transposed, and
map_coordinates(trans=True) against pixell_tpu's, whose transposes are
jax.linear_transpose of its forwards, on the CPU in float64: spline_filter
at orders 2-5 in every border, and on axes long enough (48 pixels or
more) for the port's pad to differ from the reference's; map_coordinates(trans=True) on the data
and points of tests/test_torch_interpol.py,
values and deriv=True, every border for orders 0, 1 and 3 of "spline",
"conv" order 3 and Lanczos-3, and the zero border (the 24-pixel pad kept
through the gather, then cropped) for spline orders 2 and 4. The other
(order, border) pairs are held by the adjointness of the port's own
forward and transpose there (order 5's linear_transpose alone takes the
reference ~10 s to trace). Tolerance: 1e-12 of the largest reference
value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import interpol as jinterpol
from pixell_tpu_torch import interpol

TOL = 1e-12
NPT = 40
BORDERS = ["cyclic", "nearest", "mirror", "zero"]
CASES = [(b, m, o) for b in BORDERS for m, o in [("spline", 0), ("spline", 1), ("spline", 3), ("conv", 3),
	("lanczos", 3)]] + [("zero", "spline", o) for o in (2, 4)]


def data():
	return np.random.default_rng(0).standard_normal((2, 20, 33))


@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("border", BORDERS)
def test_spline_filter(order, border):
	d = data()
	for trans in (False, True):
		want = jinterpol.spline_filter(jnp.asarray(d), order=order, axes=(-2, -1), border=border, trans=trans)
		got = interpol.spline_filter(torch.from_numpy(d), order=order, axes=(-2, -1), border=border, trans=trans)
		assert rel(got, want) <= TOL, trans
	# orders below 2 need no prefilter
	t = torch.from_numpy(d)
	assert interpol.spline_filter(t, order=1) is t


@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("border", ["nearest", "mirror", "zero"])
def test_spline_filter_long_axes(order, border):
	"""Axes of 48 pixels or more are padded by 48 before and by as much
	after as makes a length of factors 2, 3, 5 and 7 (the reference pads
	48 on each side): the same result within 1e-12, both ways."""
	d = np.random.default_rng(3).standard_normal((50, 61))
	for n, pads in [(50, (48, 49)), (61, (48, 51))]:
		assert interpol._pads(n) == pads
	assert interpol._pads(20) == (20, 20)
	for trans in (False, True):
		want = jinterpol.spline_filter(jnp.asarray(d), order=order, border=border, trans=trans)
		got = interpol.spline_filter(torch.from_numpy(d), order=order, border=border, trans=trans)
		assert rel(got, want) <= TOL, trans




def rel(got, want):
	got, want = got.numpy(), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("border,mode,order", CASES)
def test_transpose(border, mode, order):
	rng = np.random.default_rng(0)
	d = rng.standard_normal((2, 20, 33))
	p = np.stack([rng.uniform(-5, 25, NPT), rng.uniform(-5, 38, NPT)])
	for deriv in ([False] if mode == "lanczos" else [False, True]):
		v = rng.standard_normal((2,) + ((2,) if deriv else ()) + (NPT,))
		want = jinterpol.map_coordinates(jnp.asarray(d), jnp.asarray(p), odata=jnp.asarray(v), mode=mode,
			order=order, border=border, trans=True, deriv=deriv)
		got = interpol.map_coordinates(torch.from_numpy(d), torch.from_numpy(p), odata=torch.from_numpy(v),
			mode=mode, order=order, border=border, trans=True, deriv=deriv)
		assert got.shape == d.shape
		assert rel(got, want) <= TOL, deriv
