"""uharm.UHT, wavelets.WaveletTransform and lensing.lens_map_curved with
mesh= on gloo ranks: pixell_tpu_torch with a DeviceMesh of 4 and 2 ranks
against the reference's mesh run (pixell_tpu.parallel.mesh.local_mesh(4))
on the same numpy inputs, and besides against the port's one-device
results.

One spawn of four ranks (tests/torch_dist_worker.py, no JAX) runs every
case on "r4" (four ranks) and "r2" (a two-rank axis). Tolerances are
tests/test_parallel.py's, relative to the largest value:
- UHT(mode="curved", mesh=) harm2map 1e-12 and map2harm 1e-11 on a
  6-degree full-sky Fejer-1 map;
- WaveletTransform(mesh=) map2wave of that map, each scale, and wave2map:
  1e-10; under a mesh offload resolves to False;
- lens_map_curved(mesh=) (each band's rows split over the ranks, the SHTs
  ring-sharded) of the port's lensing.rand_alm draw: 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

import torch_dist_worker as W
from pixell_tpu import enmap as jenmap, utils as jutils, uharm as juharm, wavelets as jwavelets, \
	lensing as jlensing
from pixell_tpu.parallel import mesh as jmesh
from pixell_tpu_torch import enmap, utils, uharm, wavelets, lensing

MESHES = ["r4", "r2"]


def rel(got, want):
	got = np.asarray(got.data if isinstance(got, enmap.ndmap) else got)
	want = want.data.numpy() if isinstance(want, enmap.ndmap) else np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/np.abs(want).max()


def lens_inputs():
	"""The port's lensing.rand_alm draw, which the ranks make themselves."""
	return lensing.rand_alm(W.lens_spectra(), lmax=W.LENS_LMAX, seed=8, device="cpu")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
	"""(the ranks' results, the reference's): the ranks run while the
	reference computes."""
	job = W.spawn(tmp_path_factory.mktemp("ranks"), ["uharm"])
	inp = W.inputs()
	shape, wcs = W.curved_geometry(jenmap, jutils)
	m4 = jmesh.local_mesh(4)
	u = juharm.UHT(shape, wcs, mode="curved", lmax=W.LMAX, mesh=m4)
	um = u.harm2map(jnp.asarray(inp["alm"][0]))
	ref = {"uht_map": um, "uht_harm": u.map2harm(um)}
	wt = jwavelets.WaveletTransform(juharm.UHT(shape, wcs, mode="curved", lmax=W.LMAX),
		basis=jwavelets.ButterTrim(step=4), mesh=m4)
	wave = wt.map2wave(um)
	ref.update({"wave%d" % i: w for i, w in enumerate(wave.maps)})
	ref["wave_back"] = wt.wave2map(wave)
	phi, cmb = lens_inputs()
	lshape, lwcs = W.lens_geometry(jenmap, jutils)
	ref["lensed"] = jlensing.lens_map_curved(shape=(3,) + lshape, wcs=lwcs, phi_alm=jnp.asarray(phi.numpy()),
		cmb_alm=jnp.asarray(cmb.numpy()), dtype=np.float64, output="l", delta_theta=30*jutils.degree, mesh=m4)
	return job.result(), {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def one():
	"""The port's one-device results on the same inputs."""
	inp = W.inputs()
	shape, wcs = W.curved_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	u = uharm.UHT(shape, wcs, mode="curved", lmax=W.LMAX, device="cpu")
	out = {"uht_map": u.harm2map(alm[0])}
	out["uht_harm"] = u.map2harm(out["uht_map"])
	wt = wavelets.WaveletTransform(uharm.UHT(shape, wcs, mode="curved", lmax=W.LMAX, device="cpu"),
		basis=wavelets.ButterTrim(step=4))
	wave = wt.map2wave(out["uht_map"])
	out.update({"wave%d" % i: w for i, w in enumerate(wave.maps)})
	out["wave_back"] = wt.wave2map(wave)
	phi, cmb = lens_inputs()
	lshape, lwcs = W.lens_geometry(enmap, utils)
	out["lensed"] = lensing.lens_map_curved(shape=(3,) + lshape, wcs=lwcs, phi_alm=phi, cmb_alm=cmb,
		dtype=np.float64, output="l", delta_theta=30*utils.degree, device="cpu")
	return out


def held(mesh, key, tol, both, one):
	got = both[0]["uharm/%s/%s" % (mesh, key)]
	assert rel(got, both[1][key]) <= tol
	assert rel(got, one[key]) <= tol


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key,tol", [("uht_map", 1e-12), ("uht_harm", 1e-11)])
def test_uht(mesh, key, tol, both, one):
	held(mesh, key, tol, both, one)


@pytest.mark.parametrize("mesh", MESHES)
def test_wavelets(mesh, both, one):
	n = 0
	while "wave%d" % n in both[1]: n += 1
	assert n >= 2 and "wave%d" % n not in one and "uharm/%s/wave%d" % (mesh, n) not in both[0]
	for i in range(n): held(mesh, "wave%d" % i, 1e-10, both, one)
	held(mesh, "wave_back", 1e-10, both, one)
	assert not bool(both[0]["uharm/%s/offload" % mesh])   # under a mesh offload=None resolves to False


@pytest.mark.parametrize("mesh", MESHES)
def test_lensing(mesh, both, one):
	held(mesh, "lensed", 1e-10, both, one)
