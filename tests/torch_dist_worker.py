"""Rank processes for the port's multi-device tests on the CPU.

The tests spawn ranks with torch.multiprocessing on gloo, each group on a
file:// rendezvous under the test's tmp_path, so that pytest-xdist workers
never share a port. This module imports torch and the port only, so the
ranks never import JAX. main(rank, world, rdv, out, cases) runs the named
cases on every rank and rank 0 writes their gathered results to the .npz
out; inputs() makes the numpy inputs from seeds, for the ranks and for the
parent that runs the reference on the same numbers.

The meshes of four ranks: "r4", one axis "rows" over them; "r2", the
"rows" axis of a ("batch", "rows") = (2, 2) mesh, two ranks (each batch row
runs the same work); "2x2", ("rows", "cols") = (2, 2). Of two ranks: "r2",
one axis over them.
"""
import os

import numpy as np
import torch

LMAX = 16
NT, NPHI = 2*LMAX + 2, 2*LMAX + 4
LENS_LMAX = 24


def inputs():
	"""The numpy inputs of every case, from fixed seeds."""
	rng = np.random.default_rng(1)
	out = {"maps": rng.standard_normal((3, NT, NPHI)), "maps1": rng.standard_normal((1, NT, NPHI))}
	nalm = (LMAX + 1)*(LMAX + 2)//2
	l = np.zeros(nalm, int); m = np.zeros(nalm, int)
	i = 0
	for mm in range(LMAX + 1):
		for ll in range(mm, LMAX + 1):
			l[i], m[i] = ll, mm; i += 1
	a = (rng.standard_normal((3, nalm)) + 1j*rng.standard_normal((3, nalm)))/np.sqrt(2)
	a[..., m == 0] = a[..., m == 0].real*np.sqrt(2)
	a[1:, l < 2] = 0
	out["alm"] = a
	out["weights"] = rng.uniform(0.5, 1.5, 64)
	return out


def curved_geometry(enmap, utils):
	"""A 6-degree full-sky Fejer-1 map (30 x 60): 2 LMAX + 1 > 30 rings, so
	the analysis takes the upsampled 2d phase path."""
	return enmap.fullsky_geometry(res=6*utils.degree, variant="fejer1")


def cyl_geometry(enmap, utils):
	"""A CAR band off the quadrature grids: the "cyl" case."""
	return enmap.geometry(pos=np.array([[-50, 170], [40, -170]])*utils.degree, res=5*utils.degree,
		proj="car")


def lens_geometry(enmap, utils):
	"""The lensed map's geometry: a 4-degree full-sky Fejer-1 map."""
	return enmap.fullsky_geometry(res=4*utils.degree, variant="fejer1")


def lens_spectra():
	l = np.arange(LENS_LMAX + 1)
	cl = 1.0/(l + 5)**2
	ps = np.zeros((4, 4, LENS_LMAX + 1))
	ps[0, 0] = cl*1e-2
	ps[1, 1] = cl; ps[2, 2] = cl*0.1; ps[3, 3] = cl*0.01
	return ps


def _np(x):
	from torch.distributed.tensor import DTensor
	if isinstance(x, DTensor): x = x.full_tensor()
	if hasattr(x, "data") and not torch.is_tensor(x): x = x.data
	return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# cases: each takes (meshes, inp) and returns {name: numpy array}
# ---------------------------------------------------------------------------
def case_ring(meshes, inp):
	"""The ring-sharded transforms of parallel.sht_dist."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.parallel import sht_dist, mesh as pmesh
	theta, w = sht.ring_theta("F1", NT), sht.ring_weights("F1", NT)
	maps = torch.from_numpy(inp["maps"])
	alm = torch.from_numpy(inp["alm"])
	res = {}
	for name in ("r4", "r2", "2x2"):
		mesh = meshes[name]
		res[name + "/synthesis"] = _np(sht_dist.synthesis_dist(alm, theta, NPHI, mesh, lmax=LMAX))
		res[name + "/synthesis_deriv"] = _np(sht_dist.synthesis_dist(alm[0], theta, NPHI, mesh, lmax=LMAX,
			deriv=True))
		res[name + "/analysis"] = _np(sht_dist.analysis_dist(maps, theta, w, mesh, LMAX))
		res[name + "/adjoint"] = _np(sht_dist.analysis_dist(maps, theta, None, mesh, LMAX, spin=(0, 2)))
		# a DTensor input: the map sharded over rings by the reference's row_sharding
		dm = pmesh.row_sharding(mesh, 3).distribute(maps)
		res[name + "/analysis_dtensor"] = _np(sht_dist.analysis_dist(dm, theta, w, mesh, LMAX))
	return res


def case_m(meshes, inp):
	"""The m-sharded transforms of parallel.sht_dist and roundtrip_step in
	both shardings."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.parallel import sht_dist
	theta, w = sht.ring_theta("F1", NT), sht.ring_weights("F1", NT)
	maps = torch.from_numpy(inp["maps"])
	res = {}
	for name in ("r4", "r2", "2x2"):
		mesh = meshes[name]
		m_axis = "cols" if "cols" in mesh.mesh_dim_names else "rows"
		rect = sht_dist.analysis_dist_m(maps, theta, w, mesh, LMAX, m_axis=m_axis)
		res[name + "/rect"] = _np(rect)
		res[name + "/rect_local_nm"] = np.array(rect.to_local().shape[-1])
		res[name + "/synthesis_m"] = _np(sht_dist.synthesis_dist_m(rect, theta, NPHI, mesh, lmax=LMAX,
			m_axis=m_axis))
		for shard in ("rings", "m"):
			step, _ = sht_dist.roundtrip_step(mesh, LMAX, ncomp=3, shard=shard)
			om, a = step(maps)
			res[name + "/step_%s_map" % shard] = _np(om)
			res[name + "/step_%s_alm" % shard] = _np(a)
	return res


def case_comm(meshes, inp):
	import torch.distributed as tdist
	from pixell_tpu_torch import utils, mpi, mpiutils
	from pixell_tpu_torch.parallel import dist
	comm = dist.COMM_WORLD
	r, n = comm.rank, comm.size
	res = {"size": np.array(n), "world_type": np.array(type(dist.world()).__name__ == "TorchCommunicator"),
		"disabled": np.array(mpi.disabled), "fake_size": np.array(mpiutils.FAKE_WORLD.size)}
	v = np.arange(5, dtype=np.float64) + r
	res["sum"] = comm.allreduce(v)
	res["max"] = comm.allreduce(v, op="max")
	res["min"] = utils.allreduce(v, comm, op="min")
	res["scalar"] = np.array(comm.allreduce(r + 1))
	res["gather"] = comm.allgather(v)
	res["gatherv"] = utils.allgatherv(np.full(r + 1, r, np.int64), comm)
	res["bcast"] = np.asarray(comm.bcast(np.array([r*10 + 7]) if r == n - 1 else None, root=n - 1))
	comm.barrier()
	if r == 1: utils.send(np.arange(6.).reshape(2, 3)*3, comm, dest=0)
	if r == 0: res["recv"] = utils.recv(comm, source=1)
	# itemhack.Alltoallv: rank r sends i + 1 items of value 100 r + i to rank i
	sendn = np.arange(n) + 1
	sendoff = np.concatenate([[0], np.cumsum(sendn)[:-1]])
	sendbuf = np.concatenate([np.full(k, 100*r + i, np.float64) for i, k in enumerate(sendn)])
	recvn = np.full(n, r + 1)
	recvoff = np.concatenate([[0], np.cumsum(recvn)[:-1]])[::-1].copy()   # stored in reverse rank order
	recvbuf = np.zeros(int(recvn.sum()))
	mpi.itemhack.Alltoallv(sendbuf, sendn, sendoff, recvbuf, recvn, recvoff, comm)
	res["alltoallv"] = comm.allgatherv(recvbuf)
	# the complex all-reduce the sharded analysis relies on
	z = torch.full((3,), complex(r, -2*r), dtype=torch.complex128)
	tdist.all_reduce(z)
	res["complex_sum"] = z.numpy()
	return res


def case_curved(meshes, inp):
	"""curvedsky.alm2map / map2alm with mesh=, IQU and deriv=True."""
	from pixell_tpu_torch import curvedsky, enmap, utils
	shape, wcs = curved_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	res = {}
	for name in ("r4", "r2"):
		mesh = meshes[name]
		m = curvedsky.alm2map(alm, enmap.zeros((3,) + shape, wcs, device="cpu"), spin=[0, 2], mesh=mesh)
		res[name + "/alm2map"] = _np(m)
		res[name + "/map2alm"] = _np(curvedsky.map2alm(m, lmax=LMAX, spin=[0, 2], mesh=mesh))
		g = curvedsky.alm2map(alm[0], enmap.zeros((2,) + shape, wcs, device="cpu"), deriv=True, mesh=mesh)
		res[name + "/deriv"] = _np(g)
		res[name + "/deriv_alm"] = _np(curvedsky.map2alm(g, lmax=LMAX, deriv=True, mesh=mesh))
	return res


def case_cyl(meshes, inp):
	"""curvedsky.map2alm with mesh= and weights=, and alm2map / map2alm with
	mesh= on a cyl geometry."""
	from pixell_tpu_torch import curvedsky, enmap, utils
	shape, wcs = curved_geometry(enmap, utils)
	cshape, cwcs = cyl_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	res = {}
	for name in ("r4", "r2"):
		mesh = meshes[name]
		m = curvedsky.alm2map(alm, enmap.zeros((3,) + shape, wcs, device="cpu"), spin=[0, 2], mesh=mesh)
		res[name + "/weights"] = _np(curvedsky.map2alm(m, lmax=LMAX, spin=[0, 2], mesh=mesh,
			weights=inp["weights"][:shape[0]]))
		mc = curvedsky.alm2map(alm, enmap.zeros((3,) + cshape, cwcs, device="cpu"), spin=[0, 2], mesh=mesh)
		res[name + "/cyl"] = _np(mc)
		res[name + "/cyl_alm"] = _np(curvedsky.map2alm(mc, lmax=LMAX, spin=[0, 2], mesh=mesh))
	return res


def case_uharm(meshes, inp):
	"""uharm.UHT, WaveletTransform and lens_map_curved with mesh=."""
	from pixell_tpu_torch import enmap, utils, uharm, wavelets, lensing
	shape, wcs = curved_geometry(enmap, utils)
	alm = torch.from_numpy(inp["alm"])
	res = {}
	for name in ("r4", "r2"):
		mesh = meshes[name]
		u = uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, mesh=mesh, device="cpu")
		res[name + "/uht_map"] = _np(u.harm2map(alm[0]))
		res[name + "/uht_harm"] = _np(u.map2harm(enmap.ndmap(torch.from_numpy(res[name + "/uht_map"]), wcs)))
		wt = wavelets.WaveletTransform(uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, device="cpu"),
			basis=wavelets.ButterTrim(step=4), mesh=mesh)
		wave = wt.map2wave(enmap.ndmap(torch.from_numpy(res[name + "/uht_map"]), wcs))
		for i, wm in enumerate(wave.maps): res[name + "/wave%d" % i] = _np(wm)
		res[name + "/wave_back"] = _np(wt.wave2map(wave))
		res[name + "/offload"] = np.array(bool(wt.offload))
		phi, cmb = lensing.rand_alm(lens_spectra(), lmax=LENS_LMAX, seed=8, device="cpu")
		lshape, lwcs = lens_geometry(enmap, utils)
		res[name + "/lensed"] = _np(lensing.lens_map_curved(shape=(3,) + lshape, wcs=lwcs, phi_alm=phi,
			cmb_alm=cmb, dtype=np.float64, output="l", delta_theta=30*utils.degree, mesh=mesh,
			device="cpu"))
	return res


def case_tilemap(meshes, inp):
	from pixell_tpu_torch import tilemap, enmap, utils
	from pixell_tpu_torch.parallel import mesh as pmesh
	shape, wcs = enmap.fullsky_geometry(res=3*utils.degree)
	rng = np.random.default_rng(5)
	imap = enmap.ndmap(torch.from_numpy(rng.standard_normal((2,) + shape)), wcs)
	res = {}
	tm = tilemap.from_enmap(imap, tile_shape=(16, 16))
	for name in meshes:
		mesh = meshes[name]
		dtm = tilemap.distribute(tm, mesh)
		res[name + "/local_tiles"] = np.array(dtm.data.to_local().shape[-3])
		res[name + "/distributed"] = _np(dtm.data)
		rtm = tilemap.redistribute(dtm, sharding=pmesh.replicated(mesh))
		res[name + "/replicated_local"] = rtm.data.to_local().numpy()
		axis = mesh.mesh_dim_names[-1]
		back = tilemap.redistribute(rtm, mesh, axis=axis)
		res[name + "/back_local_tiles"] = np.array(back.data.to_local().shape[-3])
		res[name + "/to_enmap"] = _np(tilemap.to_enmap(back))
	# reduce sums every rank's contribution; get_active_distributed unites the active sets
	import torch.distributed as tdist
	from pixell_tpu_torch.parallel import dist
	r = tdist.get_rank()
	res["reduce"] = _np(tilemap.reduce(tm*(r + 1)).data)
	res["tree_reduce"] = _np(tilemap.tree_reduce(tm*(r + 1), dist.COMM_WORLD).data)
	part = tilemap.from_enmap(imap, tile_shape=(16, 16), active=[r, 10 + r])
	res["active_union"] = tilemap.get_active_distributed(part, dist.COMM_WORLD)
	return res


def case_tilemap_io(meshes, inp):
	"""tilemap.write_map of a TileMap distributed over the mesh (collective:
	rank 0 writes), then read_map on every rank; the file's name comes back
	for the reference to read."""
	from pixell_tpu_torch import tilemap, enmap, utils
	shape, wcs = enmap.fullsky_geometry(res=3*utils.degree)
	imap = enmap.ndmap(torch.from_numpy(np.random.default_rng(5).standard_normal((2,) + shape)), wcs)
	fname = os.path.join(inp["dir"], "tilemap_io.fits")
	dtm = tilemap.distribute(tilemap.from_enmap(imap, tile_shape=(16, 16), active=[0, 3, 5, 11]),
		next(iter(meshes.values())))
	tilemap.write_map(fname, dtm)
	back = tilemap.read_map(fname, tile_shape=(16, 16), device="cpu")
	import torch.distributed as tdist
	sums = [torch.zeros(1, dtype=torch.float64) for _ in range(tdist.get_world_size())]
	tdist.all_gather(sums, back.data.sum().reshape(1))
	return {"read": _np(back.data), "rank_sums": torch.cat(sums).numpy(), "file": np.array(fname)}


REDIST_SHAPE = (2, 12, 20)   # the global array of the redistribute case: [pre, rows, cols], cols periodic
REDIST_IBOXES = [[[[0, 6], [0, 11]], [[0, 6], [11, 20]]], [[[6, 12], [0, 20]]]]   # by rank
REDIST_OBOXES = [[[[2, 9], [15, 26]]], [[[0, 12], [0, 5]], [[5, 7], [-3, 4]]]]   # by rank; cols wrap at 20


def redist_global():
	return np.random.default_rng(27).standard_normal(REDIST_SHAPE)


def case_utils(meshes, inp):
	"""utils.reduce (sum and max, to each root) and utils.redistribute over
	the ranks, numpy over TorchCommunicator: what the other ranks hold
	comes to rank 0 by bcast."""
	from pixell_tpu_torch import utils
	from pixell_tpu_torch.parallel import dist
	comm = dist.COMM_WORLD
	r, n = comm.rank, comm.size
	v = np.arange(6.0).reshape(2, 3)*(r + 1) + r
	res = {}
	for root in range(n):
		for op in (None, "max"):
			got = utils.reduce(v, comm, root=root, op=op)
			key = "reduce_%s_root%d" % (op or "sum", root)
			res[key] = comm.bcast(got if r == root else None, root=root)
			res[key + "_others_none"] = np.array(comm.allreduce(int(r != root and got is not None)) == 0)
	g = redist_global()
	iarrs = [g[(slice(None),) + tuple(slice(*d) for d in b)] for b in REDIST_IBOXES[r]]
	oarrs = utils.redistribute(iarrs, REDIST_IBOXES[r], REDIST_OBOXES[r], comm, wrap=[0, REDIST_SHAPE[2]])
	for src in range(n):
		got = comm.bcast(oarrs if r == src else None, root=src)
		for i, a in enumerate(got): res["redistribute_rank%d_%d" % (src, i)] = a
	return res


CASES = {"ring": case_ring, "m": case_m, "comm": case_comm, "curved": case_curved, "cyl": case_cyl,
	"uharm": case_uharm, "tilemap": case_tilemap, "tilemap_io": case_tilemap_io,
	"utils": case_utils}


def meshes_of(world):
	from pixell_tpu_torch.parallel import mesh as pmesh
	if world == 2: return {"r2": pmesh.local_mesh(2, device="cpu")}
	return {"r4": pmesh.local_mesh(4, device="cpu"),
		"r2": pmesh.get_mesh((2, 2), ("batch", "rows"), device="cpu")["rows"],
		"2x2": pmesh.get_mesh((2, 2), ("rows", "cols"), device="cpu")}


def main(rank, world, rdv, out, cases):
	torch.set_num_threads(1)
	os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
	import torch.distributed as tdist
	tdist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
	try:
		meshes = meshes_of(world)
		inp = inputs()
		inp["dir"] = os.path.dirname(out)
		res = {}
		for c in cases: res.update({"%s/%s" % (c, k): v for k, v in CASES[c](meshes, inp).items()})
		if rank == 0: np.savez(out, **res)
		tdist.barrier()
	finally:
		tdist.destroy_process_group()


class spawn:
	"""Start cases on world gloo ranks; result() waits for them and returns
	their results, from rank 0's .npz. The ranks run while the caller
	computes the reference."""
	def __init__(self, tmp_path, cases, world=4):
		import torch.multiprocessing as mp
		rdv, self.out = str(tmp_path/"rendezvous"), str(tmp_path/"ranks.npz")
		self.ctx = mp.start_processes(main, args=(world, rdv, self.out, tuple(cases)), nprocs=world,
			join=False, start_method="spawn")
	def result(self):
		while not self.ctx.join(): pass
		with np.load(self.out) as f:
			return {k: f[k] for k in f.files}


class one_rank_mesh:
	"""A one-rank gloo process group (an in-process store, no network) and
	its one-axis mesh on the CPU for the block; the group is destroyed at
	its end."""
	def __enter__(self):
		import torch.distributed as tdist
		from pixell_tpu_torch.parallel import mesh as pmesh
		tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
		return pmesh.local_mesh(1, device="cpu")
	def __exit__(self, *exc):
		import torch.distributed as tdist
		tdist.destroy_process_group()
