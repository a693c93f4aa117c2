"""pixell_tpu_torch.fft's transforms against pixell_tpu.fft on the CPU in
float64, with inputs made from a numpy seed on one [3, 12, 20] shape (so
each reference program compiles once):

- fft / ifft / rfft / irfft over one and two axes, normalized and not
  (FFTW's unnormalized convention), real input promoted to complex, and
  float32 input giving complex64;
- the eight DCT / DST types forward and inverse (normalized and not), and
  redft00, chebt, ichebt;
- shift (fractional, with deriv, and nofft), resample_fft up and down,
  measure_shift, the frequency helpers and the engine shims.

Tolerance: 1e-12 of the largest reference value (the transforms sum up to
240 terms; the two FFT libraries round differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import fft as jfft
from pixell_tpu_torch import fft

SHAPE = (3, 12, 20)
TOL = 1e-12


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def data(seed=0, cplx=False):
	rng = np.random.default_rng(seed)
	x = rng.standard_normal(SHAPE)
	return x + 1j*rng.standard_normal(SHAPE) if cplx else x


@pytest.mark.parametrize("axes", [(-1,), (-2, -1)])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("cplx", [False, True])
def test_c2c(axes, normalize, cplx):
	x = data(1, cplx)
	t = torch.from_numpy(x)
	f = fft.fft(t, axes=axes, normalize=normalize)
	assert f.dtype == torch.complex128
	assert rel(f, jfft.fft(x, axes=axes, normalize=normalize)) <= TOL
	assert rel(fft.ifft(t, axes=axes, normalize=normalize), jfft.ifft(x, axes=axes, normalize=normalize)) <= TOL
	n = np.prod([SHAPE[a] for a in axes])
	back = fft.ifft(fft.fft(t, axes=axes), axes=axes, normalize=True)
	assert rel(back, x + 0j) <= TOL and rel(fft.ifft(fft.fft(t, axes=axes), axes=axes), n*(x + 0j)) <= TOL


@pytest.mark.parametrize("axes", [(-1,), (-2, -1)])
@pytest.mark.parametrize("normalize", [False, True])
def test_r2c_c2r(axes, normalize):
	x = data(2)
	t = torch.from_numpy(x)
	f = fft.rfft(t, axes=axes, normalize=normalize)
	jf = jfft.rfft(x, axes=axes, normalize=normalize)
	assert rel(f, jf) <= TOL
	for n, tod in [(None, None), (SHAPE[-1], None), (None, torch.zeros(SHAPE, dtype=torch.float64))]:
		got = fft.irfft(f, tod, n=n, axes=axes, normalize=normalize)
		want = jfft.irfft(np.asarray(jf), n=n if tod is None else SHAPE[-1], axes=axes, normalize=normalize)
		assert rel(got, want) <= TOL
	assert rel(fft.irfft(fft.rfft(t, axes=axes), n=SHAPE[-1], axes=axes, normalize=True), x) <= TOL


def test_dtypes_and_out():
	"""float32 gives complex64; integers promote; numpy input needs a device;
	into ft when given (tensor or numpy)."""
	x = data(3).astype(np.float32)
	f = fft.fft(torch.from_numpy(x))
	assert f.dtype == torch.complex64
	assert fft.rfft(torch.from_numpy(x)).dtype == torch.complex64
	assert fft.fft(torch.arange(6)).dtype == torch.complex128
	assert rel(fft.fft(x, device="cpu"), fft.fft(torch.from_numpy(x))) == 0
	out = torch.empty(SHAPE, dtype=torch.complex64)
	assert fft.fft(torch.from_numpy(x), out) is out and rel(out, f) == 0
	outn = np.empty(SHAPE, np.complex64)
	assert fft.fft(torch.from_numpy(x), outn) is outn and rel(outn, f) == 0
	assert rel(fft.ifft(f, normalize=True).real, x) <= 1e-6


KINDS = ["DCT-I", "DCT-II", "DCT-III", "DCT-IV", "DST-I", "DST-II", "DST-III", "DST-IV"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("normalize", [False, True])
def test_dct_types(kind, normalize):
	x = data(4)
	t = torch.from_numpy(x)
	fn, ifn = (fft.dct, fft.idct) if kind.startswith("DCT") else (fft.dst, fft.idst)
	jfn, jifn = (jfft.dct, jfft.idct) if kind.startswith("DCT") else (jfft.dst, jfft.idst)
	assert rel(fn(t, type=kind, normalize=normalize), jfn(x, type=kind, normalize=normalize)) <= TOL
	assert rel(ifn(t, type=kind, normalize=normalize), jifn(x, type=kind, normalize=normalize)) <= TOL
	assert rel(ifn(fn(t, type=kind), type=kind, normalize=True), x) <= TOL
	assert rel(fn(t, type=kind, axes=(-1,)), jfn(x, type=kind, axes=(-1,))) <= TOL


def test_chebyshev():
	x = data(5)
	t = torch.from_numpy(x)
	assert rel(fft.redft00(t), jfft.redft00(x)) <= TOL
	assert rel(fft.chebt(t), jfft.chebt(x)) <= TOL
	assert rel(fft.ichebt(t), jfft.ichebt(x)) <= TOL
	assert rel(fft.ichebt(fft.chebt(t)), x) <= TOL
	assert rel(fft.dct(t, type="cos"), jfft.dct(x, type="cos")) <= TOL


@pytest.mark.parametrize("cplx", [False, True])
def test_shift(cplx):
	x = data(6, cplx)
	t = torch.from_numpy(x)
	for kw in (dict(shift=[0.3, -1.7], axes=(-2, -1)), dict(shift=2.25, axes=(-1,)),
			dict(shift=[0.3, -1.7], axes=(-2, -1), deriv=1), dict(shift=[0.5, 0.5, 0.5])):
		assert rel(fft.shift(t, **kw), jfft.shift(x, **kw)) <= TOL
	f = fft.fft(t, axes=(-2, -1))
	assert rel(fft.shift(f, [0.3, -1.7], axes=(-2, -1), nofft=True),
		jfft.shift(np.asarray(f), [0.3, -1.7], axes=(-2, -1), nofft=True)) <= TOL
	# a whole-sample shift is a roll
	assert rel(fft.shift(t, 3, axes=(-1,)), np.roll(x, 3, -1)) <= TOL


@pytest.mark.parametrize("n", [[7, 9], [12, 20], [17, 33], [24, 40]])
def test_resample_fft(n):
	x = data(7)
	assert rel(fft.resample_fft(torch.from_numpy(x), n, axes=(-2, -1)),
		jfft.resample_fft(x, n, axes=(-2, -1))) <= TOL


def test_measure_shift_and_helpers():
	x = data(8)
	y = np.roll(x, 5, -1)
	got = fft.measure_shift(torch.from_numpy(x), torch.from_numpy(y))
	want = np.asarray(jfft.measure_shift(x, y))
	np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
	z = np.array(jfft.shift(x, 0.4, axes=(-1,)))
	np.testing.assert_allclose(fft.measure_shift(torch.from_numpy(z), torch.from_numpy(x)).numpy(),
		np.asarray(jfft.measure_shift(z, x)), rtol=0, atol=1e-12)
	for n, i in [(10, np.arange(10)), (11, np.arange(-3, 14))]:
		np.testing.assert_array_equal(fft.ind2freq(n, i, 0.5), jfft.ind2freq(n, i, 0.5))
		np.testing.assert_array_equal(fft.freq2ind(n, fft.ind2freq(n, i, 0.5), 0.5),
			jfft.freq2ind(n, jfft.ind2freq(n, i, 0.5), 0.5))
		np.testing.assert_array_equal(fft.fftfreq(n, 0.3), jfft.fftfreq(n, 0.3))
		np.testing.assert_array_equal(fft.rfftfreq(n, 0.3), jfft.rfftfreq(n, 0.3))
	assert fft.rfft_shape((4, 10)) == jfft.rfft_shape((4, 10)) == (4, 6)
	assert fft.irfft_shape((4, 6)) == jfft.irfft_shape((4, 6))
	assert fft.irfft_shape((4, 6), n=11) == jfft.irfft_shape((4, 6), n=11)
	np.testing.assert_array_equal(fft.rfreq2ind([0.1, 0.25], 8), jfft.rfreq2ind([0.1, 0.25], 8))
	np.testing.assert_array_equal(fft.int2rfreq(8, [1, 2], 2.0), jfft.int2rfreq(8, [1, 2], 2.0))
	assert fft.asfcarray(np.arange(3)).dtype == jfft.asfcarray(np.arange(3)).dtype
	assert fft.asfcarray(np.arange(3, dtype=np.int8)).dtype == np.float32
	assert fft.empty((2, 3), np.float32).shape == (2, 3)
	assert fft.numpy_empty_aligned((2, 3), np.complex64).dtype == np.complex64
	assert fft.nthread_fft() == fft.nthread_ifft() == 1


def test_engine_shims():
	"""One engine (torch.fft) behind the reference's interface; fft_flat,
	ifft_flat and numpy_FFTW write into their outputs."""
	fft.set_engine("torch")
	with pytest.raises(ValueError): fft.set_engine("fftw")
	x = data(9)
	t = torch.from_numpy(x)
	eng = fft.get_engine("numpy")
	assert fft.get_engine(eng) is eng and fft.get_engine("anything") is fft.get_engine("auto")
	assert rel(eng.fft(t), jfft.fft(x)) <= TOL
	assert rel(eng.ifft(t), jfft.ifft(x, normalize=True)) <= TOL
	assert rel(eng.rfft(t), jfft.rfft(x)) <= TOL
	assert rel(eng.irfft(eng.rfft(t), n=SHAPE[-1]), x) <= TOL
	ft = torch.empty(SHAPE, dtype=torch.complex128)
	fft.fft_flat(t, ft)
	assert rel(ft, jfft.fft(x)) <= TOL
	tod = np.empty(SHAPE)
	assert fft.ifft_flat(ft, tod) is tod and rel(tod, SHAPE[-1]*x) <= TOL
	b = np.empty(SHAPE, complex)
	fft.numpy_FFTW(t, b, axes=(-2, -1))()
	assert rel(b, jfft.fft(x, axes=(-2, -1))) <= TOL
	c = torch.empty(SHAPE, dtype=torch.complex128)
	fft.numpy_FFTW(torch.from_numpy(b), c, axes=(-2, -1), direction="FFTW_BACKWARD")(normalise_idft=True)
	assert rel(c, x + 0j) <= TOL


def test_numpy_input_defaults_to_cuda():
	"""Numpy input goes to CUDA unless told otherwise: without a CUDA device
	the transforms raise, and never run on the CPU by themselves."""
	x = data(10)
	for call in (lambda: fft.fft(x), lambda: fft.dct(x), lambda: fft.shift(x, 0.5),
			lambda: fft.resample_fft(x, 7), lambda: fft.measure_shift(x, x)):
		if torch.cuda.is_available():
			assert call().device.type == "cuda"
		else:
			with pytest.raises((AssertionError, RuntimeError)):
				call()
