"""pixell_tpu_torch.resample and .array_ops against pixell_tpu's on the
CPU in float64, with inputs made from a numpy seed on a 24 x 40 CAR
patch with 3 components:

- resample in each method (fft, spline, bilinear) at scales, per-axis
  scales and a target shape, as ndmaps (the wcs rescaled) and tensors;
  enmap.resample / resample_fft / downgrade_fft / upgrade_fft;
  resample_bin, downsample_bin / upsample_bin, resample_fft(_simple),
  make_equispaced;
- every function of array_ops, on tensors and on numpy (which stays
  numpy), and the core's transposed-view interface.

Tolerance: 1e-12 of the largest reference value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import resample as jresample, array_ops as jarray_ops, enmap as jenmap
from pixell_tpu_torch import resample, array_ops, enmap, utils

TOL = 1e-12


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def data(seed, shape):
	return np.random.default_rng(seed).standard_normal(shape)


def maps():
	shape, wcs = enmap.geometry(np.array([[-5, 8], [3, -6]])*utils.degree, shape=(24, 40), proj="car")
	jshape, jwcs = jenmap.geometry(np.array([[-5, 8], [3, -6]])*utils.degree, shape=(24, 40), proj="car")
	x = data(7, (3,) + shape)
	return enmap.enmap(x, wcs, device="cpu"), jenmap.enmap(x, jwcs), x


def same_wcs(a, b):
	return all(np.allclose(getattr(a.wcs.wcs, f), getattr(b.wcs.wcs, f), rtol=1e-14, atol=1e-14)
		for f in ("crpix", "cdelt", "crval"))


@pytest.mark.parametrize("method", ["fft", "spline", "bilinear"])
def test_resample(method):
	"""Scales, per-axis scales and a target shape ([16, 20]: whole factors
	above 8 are a shape, as in the reference), as ndmaps and as tensors."""
	m, jm, x = maps()
	for f in ([0.5, [16, 20]] if method == "spline" else [0.5, 2, [0.5, 0.25], [16, 20]]):
		got, want = resample.resample(m, f, method=method), jresample.resample(jm, f, method=method)
		assert rel(got.data, want) <= TOL and same_wcs(got, want), f
		assert rel(resample.resample(m.data, f, method=method), want) <= TOL
	assert resample.resample(m, [2, 2]).shape[-2:] == (48, 80)   # [2, 2] doubles; [16, 16] is a shape
	assert resample.resample(m, [16, 16]).shape[-2:] == (16, 16)
	assert rel(enmap.resample(m, (12, 20), method=method).data, jenmap.resample(jm, (12, 20), method=method)) <= TOL


def test_resample_bins_and_fft():
	m, jm, x = maps()
	got, want = resample.resample_bin(m, [0.5, 0.5]), jresample.resample_bin(jm, [0.5, 0.5])
	assert rel(got.data, want) <= TOL and same_wcs(got, want)
	t = torch.from_numpy(x)
	assert rel(resample.downsample_bin(t, [2, 3]), jresample.downsample_bin(x, [2, 3])) <= TOL
	assert rel(resample.upsample_bin(t, [2, 3]), jresample.upsample_bin(x, [2, 3])) == 0
	assert rel(resample.resample_fft_simple(t, 77), jresample.resample_fft_simple(x, 77)) <= TOL
	assert rel(resample.resample_fft(t, [20, 77]), jresample.resample_fft(x, [20, 77])) <= TOL
	for f in (enmap.downgrade_fft, enmap.upgrade_fft):
		assert rel(f(m, 2).data, getattr(jenmap, f.__name__)(jm, 2)) <= TOL
	assert rel(enmap.resample_fft(m, (12, 30)).data, jenmap.resample_fft(jm, (12, 30))) <= TOL
	rng = np.random.default_rng(8)
	times = np.cumsum(rng.uniform(0.5, 1.5, 100))
	d = rng.standard_normal((2, 100))
	(got, tg), (want, tw) = resample.make_equispaced(torch.from_numpy(d), times), jresample.make_equispaced(d, times)
	assert rel(got, want) <= TOL and np.array_equal(tg, tw)


# ---------------------------------------------------------------------------
# array_ops
# ---------------------------------------------------------------------------
def test_array_ops():
	"""Every function against the reference, on tensors and on numpy
	(which stays numpy where the reference's does; roll_rows puts host data
	on its device)."""
	rng = np.random.default_rng(9)
	A = rng.standard_normal((5, 3, 3))
	S = np.einsum("nij,nkj->nik", A, A)
	B = rng.standard_normal((5, 3, 3))
	b = rng.standard_normal((5, 3))
	T = torch.from_numpy
	for got, want in [(array_ops.matmul(T(A), T(b)), jarray_ops.matmul(A, b)),
			(array_ops.matmul(T(A), T(B)), jarray_ops.matmul(A, B)),
			(array_ops.matmul(np.moveaxis(A, 0, -1), np.moveaxis(b, 0, -1), axes=[0, 1]),
				jarray_ops.matmul(np.moveaxis(A, 0, -1), np.moveaxis(b, 0, -1), axes=[0, 1])),
			(array_ops.matmul_sym(T(S), T(b)), jarray_ops.matmul_sym(S, b)),
			(array_ops.eigpow(T(S), 0.5), jarray_ops.eigpow(S, 0.5)),
			(array_ops.eigpow(T(S), -1), jarray_ops.eigpow(S, -1)),
			(array_ops.eigflip(T(A + A.transpose(0, 2, 1))), jarray_ops.eigflip(A + A.transpose(0, 2, 1))),
			(array_ops.roll_rows(T(B[:, 0]), np.arange(5) - 2), jarray_ops.roll_rows(B[:, 0], np.arange(5) - 2)),
			(array_ops.ang2rect(T(b[:, :2].T)), jarray_ops.ang2rect(b[:, :2].T)),
			(array_ops.wrap_mm_m("matmul_multi")(T(A), T(B)), jarray_ops.wrap_mm_m("matmul_multi")(A, B))]:
		assert rel(got, want) <= TOL
	assert isinstance(array_ops.matmul(A, b), np.ndarray) and isinstance(array_ops.eigpow(S, 2), np.ndarray)
	got = array_ops.roll_rows(B[:, 0], np.arange(5) - 2, device="cpu")   # the reference's is a device array
	assert isinstance(got, torch.Tensor) and rel(got, jarray_ops.roll_rows(B[:, 0], np.arange(5) - 2)) == 0
	m, jm, x = maps()
	got, want = array_ops.find_contours(m, [-1, 0, 1.5]), jarray_ops.find_contours(jm, [-1, 0, 1.5])
	assert isinstance(got, enmap.ndmap) and got.dtype == torch.int32
	np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
	for dt in (np.float32, np.float64, torch.float64):
		assert isinstance(array_ops.get_core(dt), array_ops._Core)
	with pytest.raises(ValueError):
		array_ops.get_core(np.int32)
	core, jcore = array_ops.get_core(np.float64), jarray_ops.get_core(np.float64)
	out, jout = np.zeros((5, 3, 3)), np.zeros((5, 3, 3))
	core.matmul_multi(A.T, B.T, out.T)
	jcore.matmul_multi(A.T, B.T, jout.T)
	assert rel(out, jout) <= TOL
