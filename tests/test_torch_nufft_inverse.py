"""The inverse NUFFTs of pixell_tpu_torch.fft (iu2nu, inu2u and the aliases
nufft, inufft, nufft_adjoint, inufft_adjoint), shift_interp and
ops.solvers against pixell_tpu on the CPU, with inputs made from a numpy
seed:

- the forward names (inufft, nufft_adjoint) within 1e-12 of the largest
  reference value (float64), shift_interp (one K10 evaluation, whose twin
  the CPU runs) within 1e-12 of the reference's roll-and-FMA form in
  float64 and complex128, and in float32 within 1e-5 of the reference's
  float32 (both sum w^2 float32 terms; the port's positions are float64);
- the CG solves (iu2nu, nufft, inu2u, inufft_adjoint) within 1e-6 of the
  reference: both stop at a residual of epsilon (1e-6 by default, 1e-8
  here) of the right-hand side, and both solutions are within that of the
  normal equations' one; and each against the grid or values that made the
  samples within 1e-5 (the points over- or under-determine them, so the
  solve is well posed);
- ops.solvers.cg_solve (a tensor and a dict of tensors) and jacobi_refine
  against the reference's within 1e-12, and their iteration counts equal;
- shift_interp refuses a kernel width outside [2, 16], as K10 does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import fft as jfft
from pixell_tpu.ops import solvers as jsolvers
from pixell_tpu_torch import fft
from pixell_tpu_torch.ops import solvers

SHAPE = (8, 10)
EPS = 1e-8


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def cgrid(rng, shape):
	return rng.standard_normal(shape) + 1j*rng.standard_normal(shape)


def t(x):
	return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("flip", [False, True])
def test_forward_names(flip):
	rng = np.random.default_rng(1)
	g, inds = cgrid(rng, SHAPE), rng.uniform(-1, 7, (2, 60))
	v = cgrid(rng, 60)
	want = np.asarray(jfft.inufft(g, inds, flip=flip))
	assert rel(fft.inufft(t(g), t(inds), flip=flip, device="cpu"), want) < 1e-12
	assert rel(fft.inufft(t(g), t(inds), flip=flip, complex=False, device="cpu"), want.real) < 1e-12
	want = np.asarray(jfft.nufft_adjoint(v, inds, oshape=SHAPE, flip=flip))
	assert rel(fft.nufft_adjoint(t(v), t(inds), oshape=SHAPE, flip=flip, device="cpu"), want) < 1e-12
	# out= takes the result (a tensor is returned, a numpy array filled)
	out = np.zeros(SHAPE, complex)
	assert fft.nufft_adjoint(t(v), t(inds), out=out, flip=flip, device="cpu") is out
	assert rel(out, want) < 1e-12


@pytest.mark.parametrize("name", ["iu2nu", "nufft"])
def test_grid_from_samples(name):
	"""More points (300) than grid cells (80): the grid is determined."""
	rng = np.random.default_rng(2)
	g, inds = cgrid(rng, SHAPE), rng.uniform(0, 2*np.pi, (2, 300))
	forward = False
	a = np.asarray(jfft.u2nu(jnp.asarray(g), inds.T, forward=forward))
	want = np.asarray(getattr(jfft, name)(a, inds, oshape=SHAPE, epsilon=EPS))
	got = getattr(fft, name)(t(a), t(inds), oshape=SHAPE, epsilon=EPS, device="cpu")
	assert rel(got, want) < 1e-6
	assert rel(got, g) < 1e-5
	# the default tolerance (1e-6) still recovers the grid
	assert rel(getattr(fft, name)(t(a), t(inds), oshape=SHAPE, device="cpu"), g) < 1e-5


@pytest.mark.parametrize("name", ["inu2u", "inufft_adjoint"])
def test_values_from_grid(name):
	"""Fewer points (40) than grid cells (80): the values are determined."""
	rng = np.random.default_rng(3)
	inds, v = rng.uniform(0, 2*np.pi, (2, 40)), cgrid(rng, 40)
	# inu2u inverts nu2u(forward=False), inufft_adjoint nu2u(forward=True)
	fa = np.asarray(jfft.nu2u(jnp.asarray(v), inds.T, oshape=SHAPE, forward=name == "inufft_adjoint"))
	want = np.asarray(getattr(jfft, name)(fa, inds, epsilon=EPS))
	got = getattr(fft, name)(t(fa), t(inds), epsilon=EPS, device="cpu")
	assert rel(got, want) < 1e-6
	assert rel(got, v) < 1e-5


def test_cg_zero_rhs():
	"""A zero right-hand side gives 0, as the reference's floored start does."""
	rng = np.random.default_rng(4)
	inds = rng.uniform(0, 2*np.pi, (2, 100))
	got = fft.iu2nu(torch.zeros(100, dtype=torch.complex128), t(inds), oshape=SHAPE, device="cpu")
	assert bool((got == 0).all())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.complex128, 1e-12), (np.float32, 1e-5)])
def test_shift_interp(dtype, tol):
	"""The reference's roll-and-FMA sum equals the per-point evaluation
	(K10's) at y + dy, x + dx, on the periodic grid."""
	rng = np.random.default_rng(5)
	K, w = 2, 7
	beta = 2.3*w
	f = rng.standard_normal((2, 16, 20))
	if dtype == np.complex128: f = f + 1j*rng.standard_normal(f.shape)
	f = f.astype(dtype)
	dy, dx = rng.uniform(-K, K, (2, 16, 20))
	want = np.asarray(jfft.shift_interp(jnp.asarray(f), jnp.asarray(dy), jnp.asarray(dx), K, w, beta))
	got = fft.shift_interp(t(f), t(dy), t(dx), K, w, beta, device="cpu")
	assert got.dtype == torch.from_numpy(f).dtype
	assert rel(got, want) < tol
	with pytest.raises(ValueError):
		fft.shift_interp(t(f), t(dy), t(dx), K, 17, beta, device="cpu")
	with pytest.raises(ValueError):
		fft.shift_interp(t(f), t(dy), t(dx), K, 1, beta, device="cpu")


def spd(rng, n):
	m = rng.standard_normal((n, n))
	return m @ m.T + n*np.eye(n)


def test_cg_solve():
	rng = np.random.default_rng(6)
	A, b = spd(rng, 12), rng.standard_normal(12)
	M = np.diag(1/np.diag(A))
	for prec in (False, True):
		jx, jinfo = jsolvers.cg_solve(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
			M=(lambda x: jnp.asarray(M) @ x) if prec else None, tol=1e-10)
		x, info = solvers.cg_solve(lambda x: t(A) @ x, t(b), M=(lambda x: t(M) @ x) if prec else None, tol=1e-10)
		assert rel(x, jx) < 1e-12
		assert info["iters"] == int(jinfo["iters"])
		assert abs(float(info["err"]) - float(jinfo["err"])) <= 1e-12
		assert rel(A @ x.numpy(), b) < 1e-9
	# a dict of tensors (the reference's pytrees)
	B = spd(rng, 5)
	rhs = {"a": rng.standard_normal(12), "b": rng.standard_normal(5)}
	op = lambda v: {"a": v["a"] @ A.T, "b": v["b"] @ B.T}
	jx, _ = jsolvers.cg_solve(lambda v: {k: jnp.asarray(x) for k, x in op(v).items()},
		{k: jnp.asarray(v) for k, v in rhs.items()}, tol=1e-12)
	x, _ = solvers.cg_solve(lambda v: {"a": t(A) @ v["a"], "b": t(B) @ v["b"]},
		{k: t(v) for k, v in rhs.items()}, tol=1e-12)
	for k in rhs: assert rel(x[k], jx[k]) < 1e-12


def test_jacobi_refine():
	rng = np.random.default_rng(7)
	A, b = spd(rng, 10), rng.standard_normal(10)
	D = np.diag(1/np.diag(A))
	for niter in (0, 3):
		want = np.asarray(jsolvers.jacobi_refine(lambda x: jnp.asarray(A) @ x, lambda x: jnp.asarray(D) @ x,
			jnp.asarray(b), niter=niter))
		got = solvers.jacobi_refine(lambda x: t(A) @ x, lambda x: t(D) @ x, t(b), niter=niter)
		assert rel(got, want) < 1e-12
