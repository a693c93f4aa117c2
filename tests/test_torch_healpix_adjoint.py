"""The written-out transpose of pixell_tpu_torch's ring-structured HEALPix
synthesis and map2alm_healpix against pixell_tpu on the CPU in float64, at
nside 16 and lmax 40, with inputs from a numpy seed:

- the transpose against the reference's _healpix_ring_adjoint (jax.vjp)
  within 1e-10, and <A x, y> = <x, A^T y> within 1e-12 relative, for spin
  0 and IQU, and a map without leading axes;
- map2alm_healpix with niter 0 and 2, methods "ring" and "general",
  within 1e-10, directly and through curvedsky's name.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import reproject as jreproject
from pixell_tpu_torch import reproject, curvedsky

NSIDE, LMAX = 16, 40
NALM = (LMAX + 1)*(LMAX + 2)//2
NPIX = 12*NSIDE**2


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def rand_alm(seed, ncomp=3, lmax=LMAX):
	rng = np.random.default_rng(seed)
	n = (lmax + 1)*(lmax + 2)//2
	a = rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n))
	a[:, :lmax+1] = a[:, :lmax+1].real
	return a


def alm_dot(x, y):
	return float(np.sum(x.real*y.real + x.imag*y.imag))


@pytest.mark.parametrize("spin,ncomp", [((0,), 1), ((0, 2), 3)])
def test_ring_adjoint(spin, ncomp):
	rng = np.random.default_rng(4)
	v = rng.standard_normal((ncomp, NPIX))
	want = np.asarray(jreproject._healpix_ring_adjoint(jnp.asarray(v), NSIDE, lmax=LMAX, mmax=LMAX, spin=spin))
	got = reproject._healpix_ring_adjoint(torch.from_numpy(v), NSIDE, LMAX, LMAX, spin)
	assert rel(got, want) < 1e-10
	a = rand_alm(5, ncomp=ncomp)
	av = reproject._alm2map_healpix_ring(torch.from_numpy(a), NSIDE, LMAX, LMAX, spin).numpy()
	lhs, rhs = float(np.sum(av*v)), alm_dot(a, got.numpy())
	assert abs(lhs - rhs) <= 1e-12*abs(lhs)
	if ncomp == 1:   # a map without leading axes gives an alm without them
		flat = reproject._healpix_ring_adjoint(torch.from_numpy(v[0]), NSIDE, LMAX, LMAX, spin)
		assert flat.shape == (NALM,) and rel(flat, want[0]) < 1e-10


@pytest.mark.parametrize("method", ["ring", "general"])
@pytest.mark.parametrize("niter", [0, 2])
def test_map2alm_healpix_against_reference(method, niter):
	a = rand_alm(6)
	m = np.asarray(jreproject.alm2map_healpix(jnp.asarray(a), nside=NSIDE, spin=[0, 2]))
	want = np.asarray(jreproject.map2alm_healpix(m, lmax=LMAX, spin=[0, 2], niter=niter, method=method))
	got = reproject.map2alm_healpix(torch.from_numpy(m), lmax=LMAX, spin=[0, 2], niter=niter, method=method)
	assert got.dtype == torch.complex128
	assert rel(got, want) < 1e-10
	via = curvedsky.map2alm_healpix(torch.from_numpy(m), lmax=LMAX, spin=[0, 2], niter=niter, method=method)
	assert rel(via, want) < 1e-10
