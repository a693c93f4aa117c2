"""The port's m-sharded SHTs (pixell_tpu_torch.parallel.sht_dist:
analysis_dist_m, synthesis_dist_m, roundtrip_step in both shardings) on
four gloo ranks, against the reference's runs on its virtual CPU mesh on
the same numpy inputs.

One spawn of four ranks (tests/torch_dist_worker.py: torch and the port
only, no JAX) runs every case on three meshes: "r4", one axis of four
ranks; "r2", a two-rank axis of a (2, 2) mesh; "2x2", ("rows", "cols").
The reference's m path does not compile on a one-axis CPU mesh, so its
m-sharded transforms run on ("rows", "cols") = (1, 4) and its
roundtrip_step(shard="m") on (2, 2); its roundtrip_step(shard="rings") on
local_mesh(4). Its results do not depend on the mesh beyond rounding, and
the columns m > lmax that pad the m axis to a multiple of the mesh axis
are zero in both. Tolerances are tests/test_parallel.py's, relative to the
largest value:
- analysis_dist_m: the rect 1e-11, each rank holding only its m block
  (nm / size columns); synthesis_dist_m of it: 1e-12; the port's
  one-device analysis_rect / synthesis_rect besides;
- roundtrip_step in both shardings, map and harmonic side: 1e-10, and the
  two shardings against each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp

import torch_dist_worker as W
from pixell_tpu import sht as jsht
from pixell_tpu.parallel import mesh as jmesh, sht_dist as jdist
from pixell_tpu_torch import sht

MESHES = ["r4", "r2", "2x2"]


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/np.abs(want).max()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
	"""(the ranks' results, the reference's): the ranks run while the
	reference computes."""
	job = W.spawn(tmp_path_factory.mktemp("ranks"), ["m"])
	out = reference()
	return job.result(), out


def reference():
	"""The reference's m-sharded transforms and roundtrip steps on the same
	inputs."""
	inp = W.inputs()
	theta, w = jsht.ring_theta("F1", W.NT), jsht.ring_weights("F1", W.NT)
	maps = jnp.asarray(inp["maps"])
	devs = jax.devices()
	m14 = jmesh.get_mesh((1, 4), ("rows", "cols"), devs[:4])
	rect = jdist.analysis_dist_m(maps, theta, w, m14, W.LMAX)
	out = {"rect": np.asarray(rect), "synthesis_m": np.asarray(jdist.synthesis_dist_m(rect, theta, W.NPHI, m14,
		lmax=W.LMAX))}
	for shard, mesh in (("m", jmesh.get_mesh((2, 2), ("rows", "cols"), devs[:4])), ("rings", jmesh.local_mesh(4))):
		step, _ = jdist.roundtrip_step(mesh, W.LMAX, ncomp=3, shard=shard)
		om, a = jax.jit(step)(maps)
		out["step_%s_map" % shard], out["step_%s_alm" % shard] = np.asarray(om), np.asarray(a)
	return out


@pytest.mark.parametrize("mesh", MESHES)
def test_m_sharded(mesh, both):
	"""Each rank holds its m block only: nm / size of the rect's columns."""
	ranks, ref = both
	inp = W.inputs()
	theta, w = sht.ring_theta("F1", W.NT), sht.ring_weights("F1", W.NT)
	msize = {"r4": 4, "r2": 2, "2x2": 2}[mesh]
	nm = -(-(W.LMAX + 1)//msize)*msize
	assert int(ranks["m/%s/rect_local_nm" % mesh]) == nm//msize
	got = ranks["m/%s/rect" % mesh]
	assert got.shape == (3, W.LMAX + 1, nm)
	assert rel(got[..., :W.LMAX + 1], ref["rect"][..., :W.LMAX + 1]) <= 1e-11
	assert np.all(got[..., W.LMAX + 1:] == 0) and np.all(ref["rect"][..., W.LMAX + 1:] == 0)
	assert rel(ranks["m/%s/synthesis_m" % mesh], ref["synthesis_m"]) <= 1e-12
	rect = sht.analysis_rect(torch.from_numpy(inp["maps"]), theta, W.LMAX, w, spin=(0, 2))
	assert rel(got[..., :W.LMAX + 1], rect.numpy()) <= 1e-11
	want = sht.synthesis_rect(rect, theta, W.NPHI, spin=(0, 2))
	assert rel(ranks["m/%s/synthesis_m" % mesh], want.numpy()) <= 1e-12


@pytest.mark.parametrize("mesh", MESHES)
def test_roundtrip_step(mesh, both):
	ranks, ref = both
	m_map, r_map = ranks["m/%s/step_m_map" % mesh], ranks["m/%s/step_rings_map" % mesh]
	assert m_map.shape == (3, W.NT, W.NPHI)
	assert rel(m_map, ref["step_m_map"]) <= 1e-10
	assert rel(r_map, ref["step_rings_map"]) <= 1e-10
	assert rel(m_map, r_map) <= 1e-10
	rect = ranks["m/%s/step_m_alm" % mesh][..., :W.LMAX + 1]
	assert rel(rect, ref["step_m_alm"][..., :W.LMAX + 1]) <= 1e-10
	alm = ranks["m/%s/step_rings_alm" % mesh]
	assert rel(alm, ref["step_rings_alm"]) <= 1e-10
	assert rel(sht.alm2rect(torch.from_numpy(alm), W.LMAX).numpy(), rect) <= 1e-10
	assert float(np.std(m_map)) < float(np.std(W.inputs()["maps"]))   # the filter smooths
