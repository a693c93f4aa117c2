"""distance_from_points_healpix of pixell_tpu_torch.distances against
pixell_tpu's on the CPU (float64, inputs from a numpy seed): "brute" (K14's
plain version), "grid" (K13's) and its aliases "bubble" / "heap", "auto",
with domains, rmax, omap and odomains. Distances within 1e-12 rad, domains
identical outside 1e-12 ties; for "grid" at the pixels the reference reads
back at a cell of their own position (its read-back cell
(2 x + 1) W // (2 nx) can hold a neighbour's on rings of fewer than
W = 4 nside pixels, so that its distance there can be shorter than the
exact one; the port reads the cell ceil(x W / nx), and its grid distances
are never shorter than the brute force's). The reference's flood runs with
jax.disable_jit() (see test_torch_distances.py).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import distances as jdist
from pixell_tpu_torch import distances

TOL = 1e-12


def ties_only(a1, a2, d1, d2):
	diff = np.asarray(a1) != np.asarray(a2)
	return np.all(np.abs(np.asarray(d1) - np.asarray(d2))[diff] <= TOL)


@pytest.mark.parametrize("method", ["brute", "grid", "bubble", "heap", "auto"])
def test_distance_from_points_healpix(method):
	nside = 8
	ji, ti = jdist.healpix_info(nside), distances.healpix_info(nside)
	rng = np.random.default_rng(13)
	pix = rng.choice(ti.npix, 40, replace=False)
	dec, ra = jdist._hp_positions_all(ji)
	pts = np.array([dec[pix] + rng.uniform(-0.01, 0.01, 40), ra[pix]])   # near the pixels
	with jax.disable_jit():
		d1, l1 = jdist.distance_from_points_healpix(ji, pts, domains=True, method=method, rmax=0.4)
	d2, l2 = distances.distance_from_points_healpix(ti, pts, domains=True, method=method, rmax=0.4, device="cpu")
	assert l2.dtype == torch.int32 and d2.shape == (ti.npix,)
	ok = own_cell(ti) if method in ("grid", "bubble", "heap") else np.ones(ti.npix, bool)
	assert ok.sum() > ti.npix//2
	assert np.max(np.abs(d2.numpy() - d1)[ok]) <= TOL
	assert ties_only(l2.numpy()[ok], l1[ok], d2.numpy()[ok], d1[ok])
	om, od = torch.zeros(ti.npix, dtype=torch.float64), torch.zeros(ti.npix, dtype=torch.int32)
	got = distances.distance_from_points_healpix(ti, pts, omap=om, odomains=od, method=method, device="cpu")
	with jax.disable_jit():
		d3, l3 = jdist.distance_from_points_healpix(ji, pts, domains=True, method=method)
	assert got is om and np.max(np.abs(om.numpy() - d3)[ok]) <= TOL
	assert ties_only(od.numpy()[ok], l3[ok], om.numpy()[ok], d3[ok])


def own_cell(info):
	"""The pixels whose reference read-back cell holds their own position."""
	W = 4*info.nside
	y = np.repeat(np.arange(info.ny), info.nx)
	x = np.arange(info.npix) - info.off[y]
	return ((((2*x + 1)*W)//(2*info.nx[y]))*info.nx[y])//W == x


def test_healpix_grid_against_brute():
	"""The port's grid distances are never shorter than the exact ones by
	more than 1e-12, and agree with the reference's grid where it reads
	back a cell of the pixel's own position; elsewhere the reference's can
	be shorter than the exact distance (asserted)."""
	nside = 8
	ti = distances.healpix_info(nside)
	rng = np.random.default_rng(14)
	pts = np.array([np.arcsin(rng.uniform(-1, 1, 25)), rng.uniform(0, 2*np.pi, 25)])
	grid = distances.distance_from_points_healpix(ti, pts, method="grid", device="cpu").numpy()
	brute = distances.distance_from_points_healpix(ti, pts, method="brute", device="cpu").numpy()
	assert np.all(grid >= brute - TOL)
	with jax.disable_jit():
		jgrid = jdist.distance_from_points_healpix(jdist.healpix_info(nside), pts, method="grid")
	ok = own_cell(ti)
	assert np.max(np.abs(grid - jgrid)[ok]) <= TOL
	assert np.any(jgrid < brute - TOL)
