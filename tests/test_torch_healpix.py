"""The HEALPix geometry and transforms of pixell_tpu_torch (healpix,
reproject.alm2map_healpix / map2alm_healpix and the ring synthesis's
written-out transpose, curvedsky's HEALPix names) against pixell_tpu on the
CPU, with inputs made from a numpy seed. One nside (16) and one lmax (40)
serve the transforms, so that the reference compiles each program once:

- every healpix function against the reference, exactly, at nside 1, 8 and
  16, on pixels at the ring and cap boundaries; the device forms of
  positions and get_interpol (CPU tensors) equal to the host's;
- alm2map_healpix, ring and general, scalar, IQU and deriv=True, within
  1e-10 of the largest reference value in float64; the float32 ring
  synthesis within 2e-5 of the reference's float32;
- where the reference's cap grid oversamples the band by less than ~1.5
  (nside 8, lmax 48, the belt's m-folding case; nside 16, lmax 31), the
  port's ring synthesis against the reference's general method within
  1e-10;
- get_ring_info_healpix, npix2nside, prepare_healmap, fill_gauss and
  rand_alm_healpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import healpix as jhealpix, reproject as jreproject, curvedsky as jcurvedsky
from pixell_tpu_torch import healpix, reproject, curvedsky

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


def boundary_pixels(nside):
	"""The first and last pixel of every ring, and a few inside."""
	info = jhealpix.ring_info(nside)
	ends = np.concatenate([info["start"], info["start"] + info["nphi"] - 1])
	return np.unique(np.concatenate([ends, np.arange(0, 12*nside**2, 7)]))


@pytest.mark.parametrize("nside", [1, 8, 16])
def test_healpix_functions_against_reference(nside):
	assert healpix.npix(nside) == jhealpix.npix(nside) == healpix.nside2npix(nside)
	assert healpix.npix2nside(12*nside**2) == nside
	with pytest.raises(ValueError): healpix.npix2nside(12*nside**2 + 1)
	assert healpix.pixsize(nside) == jhealpix.pixsize(nside)
	got, want = healpix.ring_info(nside), jhealpix.ring_info(nside)
	for k in want: np.testing.assert_array_equal(got[k], want[k])
	th, ph = healpix.positions(nside)
	jth, jph = jhealpix.positions(nside)
	np.testing.assert_array_equal(th, jth)
	np.testing.assert_array_equal(ph, jph)
	tth, tph = healpix.positions(nside, device="cpu")
	np.testing.assert_array_equal(tth.numpy(), jth)
	np.testing.assert_array_equal(tph.numpy(), jph)
	pix = boundary_pixels(nside)
	for a, b in zip(healpix.pix2ang(nside, pix), jhealpix.pix2ang(nside, pix)):
		np.testing.assert_array_equal(a, b)
	# ang2pix at the pixel centres, at ring midpoints and beyond 2 pi
	rng = np.random.default_rng(nside)
	theta = np.concatenate([jth[pix], rng.uniform(0, np.pi, 200)])
	phi = np.concatenate([jph[pix], rng.uniform(-1, 7, 200)])
	np.testing.assert_array_equal(healpix.ang2pix(nside, theta, phi), jhealpix.ang2pix(nside, theta, phi))
	np.testing.assert_array_equal(healpix.ang2pix(nside, jth[pix], jph[pix]), pix)
	# get_interpol, host and on CPU tensors, poles and seams included
	theta = np.concatenate([theta, [0.0, np.pi, 1e-9]])
	phi = np.concatenate([phi, [0.0, 2*np.pi, -1e-9]])
	wp, ww = jhealpix.get_interpol(nside, theta, phi)
	gp, gw = healpix.get_interpol(nside, theta, phi)
	np.testing.assert_array_equal(gp, wp)
	np.testing.assert_array_equal(gw, ww)
	tp, tw = healpix.get_interpol(nside, torch.from_numpy(theta), torch.from_numpy(phi))
	np.testing.assert_array_equal(tp.numpy(), wp)
	assert np.abs(tw.numpy() - ww).max() <= 1e-14


SYNTH = {"scalar": ([0], 0, False), "IQU": ([0, 2], None, False), "deriv": ([0], 0, True)}


@pytest.mark.parametrize("method", ["ring", "general"])
@pytest.mark.parametrize("name", SYNTH)
def test_alm2map_healpix_against_reference(name, method):
	spin, comp, deriv = SYNTH[name]
	a = rand_alm(1)
	a = a[comp] if comp is not None else a
	want = np.asarray(jreproject.alm2map_healpix(jnp.asarray(a), nside=NSIDE, spin=spin, deriv=deriv,
		method=method))
	got = reproject.alm2map_healpix(torch.from_numpy(a), nside=NSIDE, spin=spin, deriv=deriv, method=method,
		device="cpu")
	assert got.dtype == torch.float64
	assert rel(got, want) < 1e-10
	# through curvedsky's name, with the nside from a map
	via = curvedsky.alm2map_healpix(torch.from_numpy(a), healmap=torch.zeros(NPIX), spin=spin, deriv=deriv,
		method=method)
	assert rel(via, want) < 1e-10


def test_alm2map_healpix_float32():
	"""The float32 ring synthesis against the reference's float32, and ring
	against general in float32 within the reference's own 2e-4
	(tests/test_science.py:256)."""
	a = rand_alm(2).astype(np.complex64)
	want = np.asarray(jreproject.alm2map_healpix(jnp.asarray(a), nside=NSIDE, spin=[0, 2]))
	got = reproject.alm2map_healpix(torch.from_numpy(a), nside=NSIDE, spin=[0, 2], device="cpu")
	assert got.dtype == torch.float32
	assert rel(got, want) < 2e-5
	gen = reproject.alm2map_healpix(torch.from_numpy(a), nside=NSIDE, spin=[0, 2], method="general",
		device="cpu")
	assert rel(gen, got) < 2e-4


@pytest.mark.parametrize("nside,lmax,k", [(8, 48, 5), (16, 31, 2)])
def test_cap_oversampling(nside, lmax, k):
	"""Where the reference's cap grid (N = 4 nside ceil((mmax + 1)/(2 nside)))
	oversamples the band -mmax .. mmax by less than ~1.5, its ring path
	loses the ES kernel's epsilon (nside 8, lmax 48: ~9e-10; nside 16, lmax
	31 = 2 nside - 1: ~1e-5); the port's N oversamples it by
	reproject.SIGMA_MIN or more, and its ring synthesis holds 1e-10 against
	the reference's general method. nside 8, lmax 48 is the belt's
	m-folding case: its rings of 32 pixels alias every m >= 16."""
	a = rand_alm(3, ncomp=1, lmax=lmax)[0]
	want = np.asarray(jreproject.alm2map_healpix(jnp.asarray(a), nside=nside, spin=[0], method="general"))
	got = reproject.alm2map_healpix(torch.from_numpy(a), nside=nside, spin=[0], device="cpu")
	geom = reproject._hpix_ring_geom(nside, lmax, 11, np.float64, "cpu")
	assert geom.k == k and geom.N/(2*lmax + 1) >= reproject.SIGMA_MIN
	assert rel(got, want) < 1e-10


def test_curvedsky_healpix_names():
	for nside in (1, 8, 16):
		got, want = curvedsky.get_ring_info_healpix(nside), jcurvedsky.get_ring_info_healpix(nside)
		for k in ("theta", "nphi", "phi0", "offsets"): np.testing.assert_array_equal(got[k], want[k])
		assert got.nring == want.nring
		assert curvedsky.npix2nside(12*nside**2) == jcurvedsky.npix2nside(12*nside**2) == nside
	z = curvedsky.prepare_healmap(None, nside=4, pre=(3,), device="cpu")
	assert z.shape == (3, 192) and z.dtype == torch.float64 and not bool(z.any())
	assert curvedsky.prepare_healmap(z) is z
	ps = np.zeros((3, 3, LMAX + 1)); ps[0, 0] = 1; ps[1, 1, 2:] = ps[2, 2, 2:] = 0.5
	got = curvedsky.rand_alm_healpy(ps, lmax=LMAX, seed=7, device="cpu")
	np.testing.assert_array_equal(got.numpy(), jcurvedsky.rand_alm_healpy(ps, lmax=LMAX, seed=7))
	# fill_gauss draws numpy's global generator: the same seed gives the same numbers
	for dt in (np.float64, np.complex128):
		want = np.zeros((2, 1000), dt)
		np.random.seed(8)
		jcurvedsky.fill_gauss(want, bsize=300)
		host = np.zeros((2, 1000), dt)
		np.random.seed(8)
		curvedsky.fill_gauss(host, bsize=300)
		np.testing.assert_array_equal(host, want)
		tens = torch.zeros((2, 1000), dtype=torch.from_numpy(want).dtype)
		np.random.seed(8)
		curvedsky.fill_gauss(tens, bsize=300)
		np.testing.assert_array_equal(tens.numpy(), want)
