"""pixell_tpu_torch.reproject's CAR -> HEALPix side against pixell_tpu on
the CPU in float64, with inputs from a numpy seed: an IQU map on the
2-degree full-sky Fejer-1 grid (90 x 180) made from alm at lmax 40, and
nside 16 with its default lmax 47 throughout, so that the reference
compiles each program once (healpix2map is in test_torch_healpix2map.py,
thumbnails and the small helpers in test_torch_thumbnails.py).

- map2healpix, methods "harm" and "spline", with and without
  rot="gal,equ", within 1e-10 of the largest reference value;
- the RA seam of the spline method (nside 32): at the default border
  ("constant") the port keeps the reference's values (the centres near
  RA = 180 degrees are wrong in both); at boundary="wrap" it
  agrees with a direct synthesis_general at the HEALPix centres within the
  order-3 spline's own error, SEAM_TOL of the largest value;
- map2healpix(rot="gal,equ", method="harm") against synthesis_general at
  the HEALPix centres transformed by coordinates.transform("equ", "gal"):
  within 1e-9;
- enmap.to_healpix and ndmap.to_healpix (map2healpix at the default lmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import reproject as jreproject, enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import reproject, enmap, curvedsky, coordinates, healpix, utils

NSIDE, LMAX = 16, 40
SEAM_TOL = 5e-3      # the order-3 spline on a 2-degree map, of the largest value


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


def maps(seed=1):
	"""The IQU map on the 2-degree F1 grid: (reference ndmap, port ndmap on
	CPU tensors, alm)."""
	a = rand_alm(seed)
	shape, wcs = jenmap.fullsky_geometry(res=2*utils.degree, variant="fejer1")
	jm = jcurvedsky.alm2map(jnp.asarray(a), jenmap.zeros((3,) + shape, wcs), spin=[0, 2])
	_, pwcs = enmap.fullsky_geometry(res=2*utils.degree, variant="fejer1")
	return jm, enmap.ndmap(torch.from_numpy(np.array(jm)), pwcs), a


CASES = [("harm", None), ("harm", "gal,equ"), ("spline", None), ("spline", "gal,equ")]


@pytest.mark.parametrize("method,rot", CASES)
def test_map2healpix_against_reference(method, rot):
	jm, m, _ = maps()
	want = np.asarray(jreproject.map2healpix(jm, nside=NSIDE, lmax=LMAX, rot=rot, method=method))
	got = reproject.map2healpix(m, nside=NSIDE, lmax=LMAX, rot=rot, method=method)
	assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
	assert rel(got, want) < 1e-10


def direct(a, theta, phi):
	"""The IQU field of alm a at (theta, phi) by synthesis_general."""
	loc = torch.from_numpy(np.stack([theta, phi], -1))
	return curvedsky.synthesis_general(torch.from_numpy(a), loc, lmax=LMAX, spin=[0, 2], device="cpu")


def test_spline_seam():
	"""The constant border cuts the periodic RA axis: the HEALPix centres
	near RA = 180 degrees (51 of them beyond the last column at nside 32)
	are far off in the reference and the port alike (ROADMAP Queue 3);
	boundary="wrap" mends them. The border reaches 6 pixels (12 degrees)
	into the map through the prefilter, whose response falls as 0.268^n.
	Held at |dec| < 80 degrees: beyond the F1 grid's outermost rows (+-89)
	the border, constant or wrapped, is wrong in dec in both."""
	jm, m, a = maps()
	nside = 32
	theta, phi = healpix.positions(nside)
	exact = direct(a, theta, phi).numpy()
	want = np.asarray(jreproject.map2healpix(jm, nside=nside, method="spline"))
	got = reproject.map2healpix(m, nside=nside, method="spline").numpy()
	assert rel(got, want) < 1e-10
	band = np.abs(np.pi/2 - theta) < 80*utils.degree
	seam = np.abs(utils.rewind(phi - np.pi)) < 12*utils.degree
	assert rel(got[:, seam & band], exact[:, seam & band]) > 0.1
	assert rel(got[:, band & ~seam], exact[:, band & ~seam]) < SEAM_TOL
	wrap = reproject.map2healpix(m, nside=nside, method="spline", boundary="wrap").numpy()
	assert rel(wrap[:, band], exact[:, band]) < SEAM_TOL


def test_rot_against_direct_synthesis():
	"""map2healpix(rot="gal,equ") is the field of the galactic-frame map at
	each HEALPix centre's galactic position."""
	jm, m, a = maps()
	got = reproject.map2healpix(m, nside=NSIDE, lmax=LMAX, rot="equ,gal", method="harm")
	theta, phi = healpix.positions(NSIDE)
	src = coordinates.transform("gal", "equ", np.array([phi, np.pi/2 - theta]))
	want = direct(a, np.pi/2 - src[1], src[0] % (2*np.pi)).numpy()
	# the field's I is a scalar; Q, U turn by the frames' angle, so hold I only
	assert rel(got[0], want[0]) < 1e-9


def test_enmap_to_healpix():
	"""to_healpix is map2healpix at the map's default lmax (47 at nside 16,
	where the reference's cap grid and the port's differ: the reference is
	held at lmax 40 above)."""
	_, m, _ = maps()
	want = reproject.map2healpix(m, nside=NSIDE)
	assert torch.equal(enmap.to_healpix(m, nside=NSIDE), want)
	assert torch.equal(m.to_healpix(nside=NSIDE), want)
