"""Device meshes over torch.distributed (counterpart of
pixell_tpu/parallel/mesh.py).

The reference runs one controller over a jax Mesh; the port runs SPMD:
every rank of a torch.distributed process group runs the same calls on its
own share. A mesh is a torch.distributed.device_mesh.DeviceMesh with the
reference's axis names ("rows", "cols", "batch"), and a NamedSharding is a
mesh with DTensor placements: row_sharding shards a map's row axis over
"rows" (Shard(ndim - 2)), replicated is Replicate() on every axis.

The mesh takes its backend from the device: NCCL for "cuda", gloo for
"cpu". A CUDA mesh never falls back to gloo or to the host: a default group
of another backend raises. With no process group, get_mesh initializes one
from torchrun's environment variables (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) when they are set, and as a one-rank group otherwise.
Everything of the reference's mesh.py is ported; devices= takes ranks of
the default group where the reference takes jax devices.
"""
from __future__ import annotations
import os
import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("rows", "cols", "batch")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device):
	device = torch.device(device).type
	if device not in BACKENDS: raise ValueError("no mesh backend for device '%s'" % device)
	return BACKENDS[device]


def ensure_group(device="cuda"):
	"""The default process group for a mesh on device, initialized if there
	is none: from torchrun's environment where it is set, else as one rank
	(an in-process store, no network). A group of another backend than the
	device's raises."""
	backend = _backend(device)
	if backend == "nccl" and not torch.cuda.is_available():
		raise RuntimeError("a CUDA mesh needs a CUDA device")
	if not dist.is_initialized():
		env = os.environ
		if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
			if backend == "nccl": torch.cuda.set_device(int(env.get("LOCAL_RANK", env["RANK"])))
			dist.init_process_group(backend)
		else:
			dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
	got = dist.get_backend()
	if got != backend:
		raise RuntimeError("a %s mesh needs a %s process group, not %s" % (torch.device(device).type,
			backend, got))
	return dist.group.WORLD


def get_mesh(shape=None, axis_names=None, devices=None, *, device="cuda"):
	"""A DeviceMesh over the ranks devices (all ranks of the default group by
	default; pixell_tpu.parallel.mesh.get_mesh :9), shaped shape (default:
	one axis over them all, "rows", the natural sharding of ring maps), with
	axis names axis_names (default "rows", "cols", "batch" by axis). Every
	rank of the group must call it."""
	ensure_group(device)
	if devices is None: devices = list(range(dist.get_world_size()))
	n = len(devices)
	if shape is None: shape = (n,)
	shape = tuple(int(s) for s in shape)
	if axis_names is None: axis_names = AXIS_NAMES[:len(shape)]
	ranks = np.asarray(devices[:int(np.prod(shape))], int).reshape(shape)
	from torch.distributed.device_mesh import DeviceMesh
	return DeviceMesh(torch.device(device).type, torch.from_numpy(ranks), mesh_dim_names=tuple(axis_names))


def local_mesh(n=None, axis_names=("rows",), *, device="cuda"):
	"""A one-axis mesh over the first n ranks (all by default;
	pixell_tpu.parallel.mesh.local_mesh :21)."""
	ensure_group(device)
	ranks = list(range(dist.get_world_size()))
	if n is not None: ranks = ranks[:n]
	return get_mesh((len(ranks),), axis_names, ranks, device=device)


class NamedSharding:
	"""A mesh and its DTensor placements, one per mesh axis: the
	counterpart of jax.sharding.NamedSharding. distribute(x) makes the
	DTensor of a tensor every rank holds whole; an axis whose placement is
	Shard(d) keeps that rank's chunk of dimension d (DTensor's chunk rule:
	ceil(n / size) a rank, the last ones shorter or empty)."""
	def __init__(self, mesh, placements):
		self.mesh, self.placements = mesh, tuple(placements)
	def distribute(self, x):
		from torch.distributed.tensor import distribute_tensor
		return distribute_tensor(x, self.mesh, self.placements)
	def __repr__(self):
		return "NamedSharding(%s, %s)" % (self.mesh, self.placements)


def placements(mesh, dims):
	"""One placement per axis of mesh: Shard(dims[name]) on the axes named
	in the dict dims, Replicate() on the others."""
	from torch.distributed.tensor import Shard, Replicate
	return [Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names]


def row_sharding(mesh, ndim=2, axis="rows"):
	"""The sharding of a map's row (theta / dec) axis, ndim - 2, over the
	mesh axis axis (pixell_tpu.parallel.mesh.row_sharding :27)."""
	return NamedSharding(mesh, placements(mesh, {axis: ndim - 2}))


def replicated(mesh):
	"""Every rank holds the whole tensor (pixell_tpu.parallel.mesh.replicated :33)."""
	return NamedSharding(mesh, placements(mesh, {}))


def axis_size(mesh, axis):
	"""(size, this rank's index) of the mesh axis axis."""
	return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


def block(n, size, index):
	"""(start, stop) of chunk index of n entries split over size ranks by
	DTensor's rule: ceil(n / size) a chunk, the last ones shorter or empty."""
	c = -(-n//size) if size else n
	start = min(index*c, n)
	return start, min(start + c, n)


def check(mesh):
	"""mesh itself if it is None or a DeviceMesh; anything else raises
	TypeError (a mesh= argument that is no mesh)."""
	if mesh is None: return None
	from torch.distributed.device_mesh import DeviceMesh
	if not isinstance(mesh, DeviceMesh):
		raise TypeError("mesh must be a torch.distributed DeviceMesh (parallel.mesh.get_mesh), not %s"
			% type(mesh).__name__)
	return mesh
