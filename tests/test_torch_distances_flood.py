"""The flood paths of pixell_tpu_torch.distances against pixell_tpu's on the
CPU (float64, inputs from a numpy seed; K13's plain version):
labeled_distance_transform with and without rmax, distance_from_points
with more than 1024 points (seeded at distinct pixels, no two sharing one:
which of two colliding seeds survives is fixed by neither backend) and
pointsrcs.sim_srcs_dist_transform of 1100 sources through it.
Distances within 1e-12 rad, labels and domains identical outside 1e-12
ties. The HEALPix methods are in test_torch_distances_healpix.py. The
reference's flood runs with jax.disable_jit() (see
test_torch_distances.py); one shape a method keeps its op cache warm.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import distances as jdist, enmap as jenmap, utils as jutils
from pixell_tpu_torch import distances, enmap

TOL = 1e-12


def geo():
	return jenmap.fullsky_geometry(res=4.5*jutils.degree)          # 40 x 80, RA wrapped


def ties_only(a1, a2, d1, d2):
	diff = np.asarray(a1) != np.asarray(a2)
	return np.all(np.abs(np.asarray(d1) - np.asarray(d2))[diff] <= TOL)


@pytest.mark.parametrize("rmax", [None, 0.3])
def test_labeled_distance_transform(rmax):
	shape, wcs = geo()
	rng = np.random.default_rng(11)
	labels = np.zeros(shape, np.int64)
	labels.reshape(-1)[rng.choice(labels.size, 30, replace=False)] = rng.integers(1, 6, 30)
	with jax.disable_jit():
		d1, l1 = jdist.labeled_distance_transform(jenmap.ndmap(labels, wcs), rmax=rmax)
	d2, l2 = distances.labeled_distance_transform(enmap.ndmap(torch.from_numpy(labels), wcs), rmax=rmax)
	assert l2.dtype == torch.int64
	assert np.max(np.abs(d2.data.numpy() - np.asarray(d1))) <= TOL
	assert ties_only(l2.data.numpy(), np.asarray(l1), d2.data.numpy(), np.asarray(d1))


@pytest.mark.parametrize("rmax", [None, 0.2])
def test_distance_from_points_flood(rmax):
	"""1100 points at distinct pixels, displaced by up to 0.3 pixels."""
	shape, wcs = geo()
	rng = np.random.default_rng(12)
	flat = rng.choice(int(np.prod(shape)), 1100, replace=False)
	pix = np.array([flat//shape[1], flat % shape[1]], float) + rng.uniform(-0.3, 0.3, (2, 1100))
	pts = np.asarray(jenmap.pix2sky(shape, wcs, pix))
	with jax.disable_jit():
		d1, m1 = jdist.distance_from_points(shape, wcs, pts, domains=True, rmax=rmax)
	d2, m2 = distances.distance_from_points(shape, wcs, pts, domains=True, rmax=rmax, device="cpu")
	assert m2.dtype == torch.int32
	assert np.max(np.abs(d2.data.numpy() - np.asarray(d1))) <= TOL
	assert ties_only(m2.data.numpy(), np.asarray(m1), d2.data.numpy(), np.asarray(d1))


def test_sim_srcs_dist_transform_flood():
	"""pointsrcs.sim_srcs_dist_transform of 1100 sources (the flood path) at
	distinct pixels against the reference's."""
	from pixell_tpu import pointsrcs as jpointsrcs
	from pixell_tpu_torch import pointsrcs
	shape, wcs = geo()
	rng = np.random.default_rng(15)
	flat = rng.choice(int(np.prod(shape)), 1100, replace=False)
	pix = np.array([flat//shape[1], flat % shape[1]], float) + rng.uniform(-0.3, 0.3, (2, 1100))
	pts = np.asarray(jenmap.pix2sky(shape, wcs, pix))
	srcs = np.array([pts[0], pts[1], rng.uniform(0.5, 2, 1100)]).T
	with jax.disable_jit():
		want = np.asarray(jpointsrcs.sim_srcs_dist_transform(shape, wcs, srcs, 3*jutils.degree, dtype=np.float64))
	got = pointsrcs.sim_srcs_dist_transform(shape, wcs, srcs, 3*jutils.degree, dtype=np.float64, device="cpu")
	assert np.max(np.abs(got.data.numpy() - want)) <= TOL*np.max(np.abs(want))
