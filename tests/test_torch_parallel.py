"""The port's ring-sharded SHTs and communicators
(pixell_tpu_torch.parallel.sht_dist, parallel.dist, mpi, mpiutils and the
utils names) on four gloo ranks, against the reference's runs on its
virtual CPU mesh (pixell_tpu.parallel.mesh.local_mesh(4)) on the same
numpy inputs. The m-sharded transforms are in test_torch_parallel_m.py.

One spawn of four ranks (tests/torch_dist_worker.py: torch and the port
only, no JAX) runs every case on three meshes: "r4", one axis of four
ranks; "r2", a two-rank axis of a (2, 2) mesh; "2x2", ("rows", "cols").
Each is held against the reference on local_mesh(4) (the reference's
result does not depend on its mesh beyond the order of the all-reduce's
sum). Tolerances are tests/test_parallel.py's, relative to the largest
value:
- synthesis_dist, and with deriv=True: 1e-12; the port's one-device
  synthesis besides;
- analysis_dist with ring weights, with a DTensor input and without
  weights (the adjoint): 1e-11; the port's one-device adjoint besides;
- the communicators: allreduce (sum, max, min), allgather, allgatherv,
  bcast, send / recv, mpi.itemhack.Alltoallv on all_to_all_single, and the
  complex all-reduce the sharded analysis relies on, exactly.
The mesh helpers (get_mesh, row_sharding, replicated, check) run on a
one-rank group in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

import torch_dist_worker as W
from pixell_tpu import sht as jsht
from pixell_tpu.parallel import mesh as jmesh, sht_dist as jdist
from pixell_tpu_torch import sht
from pixell_tpu_torch.parallel import mesh as pmesh

MESHES = ["r4", "r2", "2x2"]


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/np.abs(want).max()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
	"""(the ranks' results, the reference's): the ranks run while the
	reference computes."""
	job = W.spawn(tmp_path_factory.mktemp("ranks"), ["ring", "comm"])
	out = reference()
	return job.result(), out


@pytest.fixture(scope="module")
def ranks(both): return both[0]


@pytest.fixture(scope="module")
def ref(both): return both[1]


def reference():
	"""The reference's ring-sharded transforms on the same inputs."""
	inp = W.inputs()
	theta, w = jsht.ring_theta("F1", W.NT), jsht.ring_weights("F1", W.NT)
	m4 = jmesh.local_mesh(4)
	alm, maps = jnp.asarray(inp["alm"]), jnp.asarray(inp["maps"])
	return {"synthesis": np.asarray(jdist.synthesis_dist(alm, theta, W.NPHI, m4, lmax=W.LMAX)),
		"synthesis_deriv": np.asarray(jdist.synthesis_dist(alm[0], theta, W.NPHI, m4, lmax=W.LMAX, deriv=True)),
		"analysis": np.asarray(jdist.analysis_dist(maps, theta, w, m4, W.LMAX)),
		"adjoint": np.asarray(jdist.analysis_dist(maps, theta, None, m4, W.LMAX, spin=(0, 2)))}


def one_device():
	inp = W.inputs()
	theta, w = sht.ring_theta("F1", W.NT), sht.ring_weights("F1", W.NT)
	return inp, theta, w, torch.from_numpy(inp["maps"]), torch.from_numpy(inp["alm"])


@pytest.mark.parametrize("mesh", MESHES)
def test_synthesis_dist(mesh, ranks, ref):
	inp, theta, w, maps, alm = one_device()
	assert rel(ranks["ring/%s/synthesis" % mesh], ref["synthesis"]) <= 1e-12
	assert rel(ranks["ring/%s/synthesis_deriv" % mesh], ref["synthesis_deriv"]) <= 1e-12
	want = sht.synthesis(alm[0], theta, W.NPHI, lmax=W.LMAX, deriv=True)
	assert rel(ranks["ring/%s/synthesis_deriv" % mesh], want.numpy()) <= 1e-12


@pytest.mark.parametrize("mesh", MESHES)
def test_analysis_dist(mesh, ranks, ref):
	inp, theta, w, maps, alm = one_device()
	assert rel(ranks["ring/%s/analysis" % mesh], ref["analysis"]) <= 1e-11
	assert rel(ranks["ring/%s/analysis_dtensor" % mesh], ref["analysis"]) <= 1e-11
	assert rel(ranks["ring/%s/adjoint" % mesh], ref["adjoint"]) <= 1e-11
	want = sht.adjoint_synthesis(maps, theta, W.LMAX, spin=(0, 2))
	assert rel(ranks["ring/%s/adjoint" % mesh], want.numpy()) <= 1e-11


def test_communicators(ranks):
	r = lambda k: ranks["comm/" + k]
	n = 4
	v = np.arange(5.)[None] + np.arange(n)[:, None]
	assert int(r("size")) == n and bool(r("world_type")) and not bool(r("disabled"))
	assert int(r("fake_size")) == 1
	np.testing.assert_array_equal(r("sum"), v.sum(0))
	np.testing.assert_array_equal(r("max"), v.max(0))
	np.testing.assert_array_equal(r("min"), v.min(0))
	assert int(r("scalar")) == sum(range(1, n + 1))
	np.testing.assert_array_equal(r("gather"), v)
	np.testing.assert_array_equal(r("gatherv"), np.concatenate([np.full(i + 1, i) for i in range(n)]))
	np.testing.assert_array_equal(r("bcast"), [(n - 1)*10 + 7])
	np.testing.assert_array_equal(r("recv"), np.arange(6.).reshape(2, 3)*3)
	# rank q received q + 1 items of 100 i + q from every rank i, stored in reverse rank order
	want = np.concatenate([np.concatenate([np.full(q + 1, 100*i + q) for i in range(n)[::-1]]) for q in range(n)])
	np.testing.assert_array_equal(r("alltoallv"), want)
	np.testing.assert_array_equal(r("complex_sum"), np.full(3, complex(6, -12)))


def test_one_process_helpers():
	"""Without a process group the communicators are the single-process
	fallback (COMM_WORLD looked up at each use), the reference's defaults
	hold, and a one-rank mesh carries the reference's axis names and
	placements; mesh= that is no DeviceMesh raises TypeError."""
	import torch.distributed as tdist
	from torch.distributed.tensor import Shard, Replicate
	from pixell_tpu_torch import mpi, mpiutils, utils
	from pixell_tpu_torch.parallel import dist
	from pixell_tpu.parallel import dist as jpdist
	assert not tdist.is_initialized()
	assert isinstance(dist.world(), dist.FakeCommunicator) and dist.COMM_WORLD.size == 1 and mpi.disabled
	assert dist.COMM_WORLD.allreduce(5) == jpdist.COMM_WORLD.allreduce(5) == 5
	np.testing.assert_array_equal(dist.allgather(np.arange(3)), jpdist.allgather(np.arange(3)))
	np.testing.assert_array_equal(utils.allgatherv(np.arange(3)), np.arange(3))
	assert utils.allreduce(7) == 7 and mpiutils.FAKE_WORLD.size == 1
	buf = np.zeros(5)
	mpi.itemhack.Alltoallv(np.arange(5.), [3], [2], buf, [3], [1], dist.COMM_SELF)
	np.testing.assert_array_equal(buf, [0, 2, 3, 4, 0])
	with pytest.raises(TypeError):
		pmesh.check(object())
	if not torch.cuda.is_available():
		with pytest.raises(RuntimeError):
			pmesh.ensure_group("cuda")
	with W.one_rank_mesh() as m:
		assert m.mesh_dim_names == ("rows",) and m.size() == 1
		assert isinstance(dist.world(), dist.FakeCommunicator)   # one rank: the fallback
		g = pmesh.get_mesh(device="cpu")
		assert g.mesh_dim_names == ("rows",)
		assert list(pmesh.row_sharding(g, 3).placements) == [Shard(1)]
		assert list(pmesh.replicated(g).placements) == [Replicate()]
		x = torch.arange(12.).reshape(3, 4)
		assert torch.equal(pmesh.row_sharding(g).distribute(x).full_tensor(), x)
		with pytest.raises(RuntimeError):
			pmesh.ensure_group("cuda")   # a gloo group serves no CUDA mesh
	assert pmesh.block(10, 4, 3) == (9, 10) and pmesh.block(5, 4, 3) == (5, 5)
