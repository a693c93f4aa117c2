"""pixell_tpu_torch.reproject.healpix2map and enmap.from_healpix against
pixell_tpu on the CPU in float64: an IQU HEALPix map at nside 16 made from
alm at lmax 40 by the reference, projected onto the 3-degree full-sky
Fejer-1 grid at lmax 40, methods "harm" and "spline", with and without
rot="gal,equ", within 1e-10 of the largest reference value; extensive=True
scales by the pixel areas' ratio; enmap.from_healpix.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import reproject as jreproject, enmap as jenmap
from pixell_tpu_torch import reproject, enmap, healpix, utils

NSIDE, LMAX = 16, 40


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def rand_alm(seed, ncomp=3, lmax=LMAX):
	rng = np.random.default_rng(seed)
	n = (lmax + 1)*(lmax + 2)//2
	l = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
	a = (rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n)))/(1.0 + l)
	a[:, :lmax+1] = a[:, :lmax+1].real
	a[1:, l < 2] = 0
	return a


CASES = [("harm", None), ("harm", "gal,equ"), ("spline", None), ("spline", "gal,equ")]


@pytest.mark.parametrize("method,rot", CASES)
def test_healpix2map_against_reference(method, rot):
	a = rand_alm(2)
	hp = np.asarray(jreproject.alm2map_healpix(jnp.asarray(a), nside=NSIDE, spin=[0, 2]))
	shape, wcs = jenmap.fullsky_geometry(res=3*utils.degree, variant="fejer1")
	_, pwcs = enmap.fullsky_geometry(res=3*utils.degree, variant="fejer1")
	want = np.asarray(jreproject.healpix2map(hp, shape, wcs, lmax=LMAX, rot=rot, method=method))
	got = reproject.healpix2map(torch.from_numpy(hp), shape, pwcs, lmax=LMAX, rot=rot, method=method)
	assert isinstance(got, enmap.ndmap) and got.wcs == pwcs
	assert rel(got.data, want) < 1e-10
	# extensive scales by the pixel areas' ratio
	ext = reproject.healpix2map(torch.from_numpy(hp[0]), shape, pwcs, method="spline", extensive=True)
	plain = reproject.healpix2map(torch.from_numpy(hp[0]), shape, pwcs, method="spline")
	assert rel(ext.data, plain.data*enmap.pixsize(shape, pwcs)/healpix.pixsize(NSIDE)) < 1e-14



def test_enmap_from_healpix():
	"""from_healpix is healpix2map at its default lmax (3 nside - 1 = 47,
	where the reference's cap grid and the port's differ: the reference is
	held at lmax 40 above)."""
	hp = np.asarray(jreproject.alm2map_healpix(jnp.asarray(rand_alm(2)), nside=NSIDE, spin=[0, 2]))
	_, pwcs = enmap.fullsky_geometry(res=3*utils.degree, variant="fejer1")
	shape = (60, 120)
	got = enmap.from_healpix(hp, shape, pwcs, device="cpu")
	assert torch.equal(got.data, reproject.healpix2map(torch.from_numpy(hp), shape, pwcs).data)
