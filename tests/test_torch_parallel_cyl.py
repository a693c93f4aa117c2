"""curvedsky.map2alm with mesh= and weights=, and alm2map / map2alm with
mesh= on a cyl geometry, on gloo ranks: pixell_tpu_torch with a DeviceMesh
of 4 and 2 ranks against the reference's mesh run
(pixell_tpu.parallel.mesh.local_mesh(4)) on the same numpy inputs, and
besides against the port's one-device results.

One spawn of four ranks (tests/torch_dist_worker.py, no JAX) runs every
case on "r4" (four ranks) and "r2" (a two-rank axis). Tolerances are
tests/test_parallel.py's, relative to the largest value, 1e-12 for a
synthesis and 1e-11 for an analysis:
- map2alm with ring weights of the IQU map on a 6-degree full-sky Fejer-1
  map (the all-reduce where the quadrature is native to the map's rings);
- IQU on a CAR band off the quadrature grids ("cyl": ring-sharded with one
  all-reduce).
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
	job = W.spawn(tmp_path_factory.mktemp("ranks"), ["cyl"])
	inp = W.inputs()
	shape, wcs = W.curved_geometry(jenmap, jutils)
	cshape, cwcs = W.cyl_geometry(jenmap, jutils)
	m4 = jmesh.local_mesh(4)
	alm = jnp.asarray(inp["alm"])
	jm = jcurvedsky.alm2map(alm, jenmap.zeros((3,) + shape, wcs), spin=[0, 2], mesh=m4)
	mc = jcurvedsky.alm2map(alm, jenmap.zeros((3,) + cshape, cwcs), spin=[0, 2], mesh=m4)
	ref = {"weights": jcurvedsky.map2alm(jm, lmax=W.LMAX, spin=[0, 2], mesh=m4,
			weights=jnp.asarray(inp["weights"][:shape[0]])),
		"cyl": mc, "cyl_alm": jcurvedsky.map2alm(mc, lmax=W.LMAX, spin=[0, 2], mesh=m4)}
	return job.result(), {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def one():
	"""The port's one-device results on the same inputs."""
	inp = W.inputs()
	shape, wcs = W.curved_geometry(enmap, utils)
	cshape, cwcs = W.cyl_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	m = curvedsky.alm2map(alm, enmap.zeros((3,) + shape, wcs, device="cpu"), spin=[0, 2])
	mc = curvedsky.alm2map(alm, enmap.zeros((3,) + cshape, cwcs, device="cpu"), spin=[0, 2])
	return {"weights": curvedsky.map2alm(m, lmax=W.LMAX, spin=[0, 2], weights=inp["weights"][:shape[0]]),
		"cyl": mc, "cyl_alm": curvedsky.map2alm(mc, lmax=W.LMAX, spin=[0, 2])}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key,tol", [("weights", 1e-11), ("cyl", 1e-12), ("cyl_alm", 1e-11)])
def test_curvedsky_weights_and_cyl(mesh, key, tol, both, one):
	got = both[0]["cyl/%s/%s" % (mesh, key)]
	assert rel(got, both[1][key]) <= tol
	want = one[key]
	assert rel(got, want.data.numpy() if isinstance(want, enmap.ndmap) else want.numpy()) <= tol
