"""curvedsky.alm2map / map2alm with mesh= on gloo ranks: pixell_tpu_torch
with a DeviceMesh of 4 and 2 ranks against the reference's mesh run
(pixell_tpu.parallel.mesh.local_mesh(4)) on the same numpy inputs, and
besides against the port's one-device results: IQU and deriv=True. map2alm
with weights= and a cyl geometry are in test_torch_parallel_cyl.py, UHT,
WaveletTransform and lens_map_curved with mesh= in
test_torch_parallel_uharm.py.

One spawn of four ranks (tests/torch_dist_worker.py, no JAX) runs every
case on "r4" (four ranks) and "r2" (a two-rank axis). Tolerances are
tests/test_parallel.py's, relative to the largest value, 1e-12 for a
synthesis and 1e-11 for an analysis:
- IQU on a 6-degree full-sky Fejer-1 map; its map2alm takes the 2d phase
  path (the map's rows too few for the quadrature: each rank's ring FFTs,
  one all-to-all to m blocks, the theta upsample and quadrature on the
  rank's m block through K2/K4 with its first m, an all-gather);
- deriv=True both ways.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

import torch_dist_worker as W
from pixell_tpu import curvedsky as jcurvedsky, enmap as jenmap, utils as jutils
from pixell_tpu.parallel import mesh as jmesh
from pixell_tpu_torch import curvedsky, enmap, utils

MESHES = ["r4", "r2"]


def rel(got, want):
	got = np.asarray(got.data if isinstance(got, enmap.ndmap) else got)
	want = want.data.numpy() if isinstance(want, enmap.ndmap) else np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/np.abs(want).max()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
	"""(the ranks' results, the reference's): the ranks run while the
	reference computes."""
	job = W.spawn(tmp_path_factory.mktemp("ranks"), ["curved"])
	inp = W.inputs()
	shape, wcs = W.curved_geometry(jenmap, jutils)
	m4 = jmesh.local_mesh(4)
	alm = jnp.asarray(inp["alm"])
	jm = jcurvedsky.alm2map(alm, jenmap.zeros((3,) + shape, wcs), spin=[0, 2], mesh=m4)
	g = jcurvedsky.alm2map(alm[0], jenmap.zeros((2,) + shape, wcs), deriv=True, mesh=m4)
	ref = {"alm2map": jm, "map2alm": jcurvedsky.map2alm(jm, lmax=W.LMAX, spin=[0, 2], mesh=m4),
		"deriv": g, "deriv_alm": jcurvedsky.map2alm(g, lmax=W.LMAX, deriv=True, mesh=m4)}
	return job.result(), {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def one():
	"""The port's one-device results on the same inputs."""
	inp = W.inputs()
	shape, wcs = W.curved_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	m = curvedsky.alm2map(alm, enmap.zeros((3,) + shape, wcs, device="cpu"), spin=[0, 2])
	g = curvedsky.alm2map(alm[0], enmap.zeros((2,) + shape, wcs, device="cpu"), deriv=True)
	return {"alm2map": m, "map2alm": curvedsky.map2alm(m, lmax=W.LMAX, spin=[0, 2]), "deriv": g,
		"deriv_alm": curvedsky.map2alm(g, lmax=W.LMAX, deriv=True)}


def held(mesh, key, tol, both, one):
	got = both[0]["curved/%s/%s" % (mesh, key)]
	assert rel(got, both[1][key]) <= tol
	want = one[key]
	assert rel(got, want.data.numpy() if isinstance(want, enmap.ndmap) else want.numpy()) <= tol


@pytest.mark.parametrize("mesh", MESHES)
def test_curvedsky_against_reference_mesh(mesh, both, one):
	held(mesh, "alm2map", 1e-12, both, one)
	held(mesh, "map2alm", 1e-11, both, one)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key,tol", [("deriv", 1e-12), ("deriv_alm", 1e-11)])
def test_curvedsky_deriv(mesh, key, tol, both, one):
	held(mesh, key, tol, both, one)
