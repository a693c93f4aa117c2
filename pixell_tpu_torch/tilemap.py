"""Tiled, distributable maps (counterpart of pixell_tpu/tilemap.py).

A TileMap splits a big map geometry into a grid of tiles, of which only an
"active" subset is stored, as one tensor [..., nactive, tny, tnx] (edge
tiles zero padded). The reference distributes tiles with jax.sharding;
here the tile axis is a DTensor placement: distribute shards it over a
DeviceMesh (Shard on the tile axis, the tile count padded to a multiple of
the ranks), redistribute changes the placement (an all-to-all, or an
all-gather to Replicate), and reduce is an all-reduce over the default
process group. Splitting a map into tiles and putting it back are one pad
and one permuted copy on the map's device.

write_map writes the assembled map through enmap.write_map (a DTensor's
tiles gathered first, by every rank: collective, as in the reference; rank
0 writes), and read_map reads a map file and tiles it.
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap
from .parallel import mesh as pmesh, sht_dist


class TileGeometry:
	"""Tile grid info for a map geometry (pixell_tpu.tilemap.TileGeometry :19)."""
	def __init__(self, shape, wcs, tile_shape=(500, 500), active=None):
		self.shape = tuple(shape)
		self.wcs = wcs
		self.tile_shape = tuple(int(t) for t in np.zeros(2, int) + np.asarray(tile_shape))
		ny, nx = self.shape[-2:]
		self.grid_shape = ((ny + self.tile_shape[0] - 1)//self.tile_shape[0],
			(nx + self.tile_shape[1] - 1)//self.tile_shape[1])
		self.ntile = int(np.prod(self.grid_shape))
		if active is None: active = np.arange(self.ntile)
		self.active = _parse_active(active, self.ntile)
		self.lookup = np.full(self.ntile, -1, int)
		self.lookup[self.active] = np.arange(len(self.active))
	@property
	def nactive(self): return len(self.active)
	@property
	def pre(self): return self.shape[:-2]
	def grid2ind(self, ty, tx):
		"""Index in the full tiling of the tile at grid coords ty, tx."""
		return ty*self.grid_shape[1] + tx
	def ind2grid(self, i):
		"""Grid coords ty, tx of tile #i."""
		nx = self.grid_shape[-1]
		return i//nx, i % nx
	@property
	def size(self):
		"""Total number of stored elements (without the edge tiles' padding)."""
		tot = 0
		for ti in self.active:
			pb = self.tile_pixbox(int(ti))
			tot += int(np.prod(pb[1] - pb[0]))
		return int(np.prod(self.pre, dtype=int))*tot
	@property
	def tiles(self):
		"""tile_geom.tiles[i] = enmap geometry of tile #i."""
		return _TileGeomHelper(self)
	def compatible(self, other):
		"""2 = strictly compatible (same tiling and active set), 1 = same
		tiling but different active sets, 0 = incompatible."""
		if tuple(self.shape[-2:]) != tuple(other.shape[-2:]): return 0
		if tuple(self.tile_shape) != tuple(other.tile_shape): return 0
		if self.nactive == other.nactive and np.all(self.active == other.active):
			return 2
		return 1
	def tile_pixbox(self, ti):
		"""Pixel box [{from,to},{y,x}] of global tile index ti."""
		gy, gx = np.unravel_index(ti, self.grid_shape)
		y1 = gy*self.tile_shape[0]; x1 = gx*self.tile_shape[1]
		y2 = min(y1 + self.tile_shape[0], self.shape[-2])
		x2 = min(x1 + self.tile_shape[1], self.shape[-1])
		return np.array([[y1, x1], [y2, x2]])
	def tile_geometry(self, ti):
		pb = self.tile_pixbox(ti)
		tshape, twcs = enmap.slice_geometry(self.shape[-2:], self.wcs,
			(slice(pb[0, 0], pb[1, 0]), slice(pb[0, 1], pb[1, 1])))
		return self.pre + tuple(tshape[-2:]), twcs
	def copy(self, pre=None, active=None, add_active=None):
		shape = tuple(pre) + self.shape[-2:] if pre is not None else self.shape
		act = self.active if active is None else _parse_active(active, self.ntile)
		if add_active is not None:
			add = _parse_active(add_active, self.ntile)
			lookup = np.full(self.ntile, -1, int)
			lookup[act] = np.arange(len(act))
			act = np.concatenate([act, add[lookup[add] < 0]])
		return TileGeometry(shape, self.wcs, self.tile_shape, act)
	def __repr__(self):
		return "TileGeometry(%s, grid=%s, nactive=%d)" % (str(self.shape), str(self.grid_shape), self.nactive)


class _TileGeomHelper:
	"""tile_geom.tiles[i] -> enmap geometry of tile #i in the full tiling."""
	def __init__(self, tile_geom):
		self.tile_geom = tile_geom
	def __getitem__(self, i):
		return self.tile_geom.tile_geometry(int(i))


def _parse_active(active, ntile):
	if isinstance(active, str) and active == "all":
		return np.arange(ntile, dtype=int)
	return np.asarray(active, int)


def geometry(shape, wcs, tile_shape=(500, 500), active=None):
	"""Build a TileGeometry (pixell_tpu.tilemap.geometry :121)."""
	return TileGeometry(shape, wcs, tile_shape=tile_shape, active=active)


def _dt(dtype):
	return enmap._torch_dtype(dtype)


def _plain(x):
	"""The whole tensor of x: a DTensor gathered, else x."""
	return sht_dist.full(x)


def _active_index(geo, device):
	return torch.from_numpy(np.asarray(geo.active, np.int64)).to(device)


class TileMap:
	"""Active tiles of a tiled map, stored as [..., nactive, tny, tnx]
	(zero-padded edge tiles); after distribute, a DTensor whose tile axis is
	sharded over a mesh (padded to a multiple of its ranks)."""
	def __init__(self, arr, geometry):
		self.data = arr
		self.geometry = geometry
	@property
	def shape(self): return self.data.shape
	@property
	def dtype(self): return self.data.dtype
	@property
	def device(self): return self.data.device
	@property
	def pre(self): return self.geometry.pre
	@property
	def nactive(self): return self.geometry.nactive
	@property
	def active(self): return self.geometry.active
	@property
	def lookup(self): return self.geometry.lookup
	@property
	def ntile(self): return self.geometry.ntile
	@property
	def tile_shape(self): return self.geometry.tile_shape
	def copy(self):
		return TileMap(self.data.clone(), self.geometry)
	def contig(self):
		"""A contiguous copy (pixell_tpu.tilemap.TileMap.contig :137)."""
		return TileMap(self.data.contiguous(), self.geometry)
	def tile(self, i):
		"""The i-th ACTIVE tile as an ndmap (cropped to its true size)."""
		ti = self.geometry.active[i]
		pb = self.geometry.tile_pixbox(ti)
		tshape, twcs = self.geometry.tile_geometry(ti)
		h, w = pb[1] - pb[0]
		return enmap.ndmap(_plain(self.data)[..., i, :h, :w], twcs)
	@property
	def tiles(self):
		"""View over ALL tiles by global index."""
		return TileView(self, active=False)
	@property
	def active_tiles(self):
		"""View over the active tiles."""
		return TileView(self, active=True)
	def with_tiles(self, other, strict=False):
		"""Re-tile onto another active set (pixell_tpu.tilemap.TileMap.
		with_tiles :160): other a TileMap / TileGeometry or an active list.
		By default the union of the active sets (new tiles zero); strict=True
		takes exactly other's active set in its order."""
		try: active = other.geometry.active
		except AttributeError:
			try: active = other.active
			except AttributeError: active = _parse_active(other, self.ntile)
		if not strict and (len(active) == len(self.geometry.active)
				and np.all(np.asarray(active) == self.geometry.active)):
			return self.copy()
		newgeo = self.geometry.copy(active=active) if strict else self.geometry.copy(add_active=active)
		data = _plain(self.data)
		src = self.geometry.lookup[newgeo.active]
		have = src >= 0
		out = data.new_zeros(data.shape[:-3] + (newgeo.nactive,) + tuple(self.geometry.tile_shape))
		if have.any():
			j = torch.from_numpy(np.nonzero(have)[0]).to(data.device)
			i = torch.from_numpy(src[have]).to(data.device)
			out[..., j, :, :] = data[..., i, :, :]
		return TileMap(out, newgeo)
	def insert(self, imap, op=lambda a, b: b):
		"""Insert imap's tiles into a copy of self."""
		return insert(self, imap, op=op)
	def to_enmap(self):
		"""Assemble the full map (missing tiles zero)."""
		return to_enmap(self)
	def __add__(self, other):
		o = other.data if isinstance(other, TileMap) else other
		return TileMap(self.data + o, self.geometry)
	def __mul__(self, other):
		o = other.data if isinstance(other, TileMap) else other
		return TileMap(self.data*o, self.geometry)
	__radd__ = __add__
	__rmul__ = __mul__
	def __sub__(self, other):
		o = other.data if isinstance(other, TileMap) else other
		return TileMap(self.data - o, self.geometry)
	def __repr__(self):
		return "TileMap(%s, %s)" % (str(tuple(self.data.shape)), repr(self.geometry))


def zeros(geometry, dtype=np.float64, jax_array=True, *, device="cuda"):
	"""A zero TileMap (pixell_tpu.tilemap.zeros :214) on device; jax_array=False
	keeps it on the host (the CPU)."""
	arr = torch.zeros(geometry.pre + (geometry.nactive,) + geometry.tile_shape, dtype=_dt(dtype),
		device=device if jax_array else "cpu")
	return TileMap(arr, geometry)


def from_enmap(imap, tile_shape=(500, 500), active=None):
	"""Split an ndmap into a TileMap on its device (pixell_tpu.tilemap.
	from_enmap :219): the map zero padded to whole tiles, its tiles taken
	out with one permuted copy, and the active ones kept."""
	geo = TileGeometry(imap.shape, imap.wcs, tile_shape, active)
	src = imap.data if isinstance(imap, enmap.ndmap) else torch.as_tensor(imap)
	(gy, gx), (th, tw) = geo.grid_shape, geo.tile_shape
	ny, nx = src.shape[-2:]
	pad = torch.nn.functional.pad(src, (0, gx*tw - nx, 0, gy*th - ny))
	pre = tuple(src.shape[:-2])
	tiles = pad.reshape(pre + (gy, th, gx, tw)).movedim(-3, -2).reshape(pre + (gy*gx, th, tw))
	if geo.nactive != geo.ntile or np.any(geo.active != np.arange(geo.ntile)):
		tiles = tiles[..., _active_index(geo, src.device), :, :]
	return TileMap(tiles.contiguous(), geo)


def to_enmap(tile_map):
	"""Assemble the full map from a TileMap, missing tiles zero
	(pixell_tpu.tilemap.to_enmap :410), on the data's device."""
	geo = tile_map.geometry
	data = _plain(tile_map.data)[..., :geo.nactive, :, :]
	(gy, gx), (th, tw) = geo.grid_shape, geo.tile_shape
	pre = tuple(data.shape[:-3])
	full = data.new_zeros(pre + (geo.ntile, th, tw))
	full[..., _active_index(geo, data.device), :, :] = data
	full = full.reshape(pre + (gy, gx, th, tw)).movedim(-2, -3).reshape(pre + (gy*th, gx*tw))
	ny, nx = geo.shape[-2:]
	return enmap.ndmap(full[..., :ny, :nx].contiguous(), geo.wcs)


# ---------------------------------------------------------------------------
# Distribution: the tile axis as a DTensor placement (pixell_tpu/tilemap.py:227-267)
# ---------------------------------------------------------------------------
def tile_sharding(mesh, pre_ndim=0, axis=None):
	"""The sharding that places the tile axis (pre_ndim from the front) over
	the mesh axis axis, or over every axis of the mesh (pixell_tpu.tilemap.
	tile_sharding :230)."""
	from torch.distributed.tensor import Shard
	names = mesh.mesh_dim_names
	if axis is None: return pmesh.NamedSharding(mesh, [Shard(pre_ndim)]*len(names))
	return pmesh.NamedSharding(mesh, pmesh.placements(mesh, {axis: pre_ndim}))


def _ranks(mesh, axis):
	return int(mesh.size()) if axis is None else pmesh.axis_size(mesh, axis)[0]


def distribute(tmap, mesh, axis=None):
	"""Shard the TileMap's tile axis over the mesh (pixell_tpu.tilemap.
	distribute :237), the tile count padded with zero tiles to a multiple
	of the ranks: each rank keeps its contiguous share of the tiles of the
	map every rank holds whole."""
	from torch.distributed.tensor import DTensor
	mesh = pmesh.check(mesh)
	data = _plain(tmap.data)
	n = data.shape[-3]
	npad = (-n) % _ranks(mesh, axis)
	if npad:
		data = torch.nn.functional.pad(data, (0, 0, 0, 0, 0, npad))
	sh = tile_sharding(mesh, pre_ndim=data.ndim - 3, axis=axis)
	loc = data
	for d, p in zip(range(mesh.ndim), sh.placements):
		if p.is_shard():
			size, idx = mesh.size(d), mesh.get_local_rank(d)
			i0, i1 = pmesh.block(loc.shape[-3], size, idx)
			loc = loc[..., i0:i1, :, :]
	return TileMap(DTensor.from_local(loc.contiguous(), mesh, sh.placements, run_check=False,
		shape=data.shape, stride=sht_dist._contiguous_stride(data.shape)), tmap.geometry)


def redistribute(tmap, mesh=None, sharding=None, axis=None):
	"""Change the distribution of a TileMap (pixell_tpu.tilemap.redistribute
	:251): to sharding (a parallel.mesh.NamedSharding), or to the tile
	sharding of the mesh's axis axis; a DTensor redistribute, the
	all-to-all of the reference's MPI version (an all-gather for Replicate)."""
	from torch.distributed.tensor import DTensor
	if sharding is None:
		sharding = tile_sharding(pmesh.check(mesh), pre_ndim=tmap.data.ndim - 3, axis=axis)
	data = tmap.data
	if not isinstance(data, DTensor):   # a tensor every rank holds whole: replicated
		data = DTensor.from_local(data, sharding.mesh, pmesh.placements(sharding.mesh, {}),
			run_check=False)
	return TileMap(data.redistribute(sharding.mesh, sharding.placements), tmap.geometry)


def reduce(tmap, comm=None, root=0):
	"""Sum TileMap contributions across ranks (pixell_tpu.tilemap.reduce
	:260): an all-reduce of the tiles over the default process group (on the
	data's device), the identity for a single rank or the FakeCommunicator."""
	from .parallel import dist as pdist
	comm = comm or pdist.COMM_WORLD
	if getattr(comm, "size", 1) == 1: return tmap
	data = _plain(tmap.data).clone()
	torch.distributed.all_reduce(data)
	return TileMap(data, tmap.geometry)


def tree_reduce(tmap, comm=None):
	"""reduce, whose all-reduce already takes a tree (pixell_tpu.tilemap.tree_reduce :270)."""
	return reduce(tmap, comm=comm)


def write_map(fname, tmap, comm=None):
	"""The TileMap written as its assembled map (missing tiles zero) by
	enmap.write_map (pixell_tpu.tilemap.write_map :268). Collective on a
	mesh: every rank gathers the tiles, rank 0 writes, and the ranks meet
	after the write."""
	full = tmap.to_enmap()
	dist = torch.distributed.is_available() and torch.distributed.is_initialized()
	if not dist or torch.distributed.get_rank() == 0:
		enmap.write_map(fname, full)
	if dist: torch.distributed.barrier()


def read_map(fname, tile_shape=(500, 500), *, device="cuda"):
	"""The map of a file, read by enmap.read_map onto device and tiled
	(pixell_tpu.tilemap.read_map :274)."""
	return from_enmap(enmap.read_map(fname, device=device), tile_shape=tile_shape)


# ---------------------------------------------------------------------------
# Additional constructors and operations (pixell_tpu/tilemap.py:286-413)
# ---------------------------------------------------------------------------
def empty(tile_geom, dtype=np.float64, *, device="cuda"):
	"""A zero TileMap with the given geometry (pixell_tpu.tilemap.empty :290)."""
	return zeros(tile_geom, dtype, device=device)


def from_active_tiles(tiles, tile_geom):
	"""TileMap from the list of active tiles matching tile_geom.active
	(pixell_tpu.tilemap.from_active_tiles :294); edge tiles zero padded."""
	if len(tiles) != tile_geom.nactive:
		raise ValueError("Wrong number of tiles passed. Expected %d but got %d"
			% (tile_geom.nactive, len(tiles)))
	if len(tiles) == 0: return zeros(tile_geom, device="cpu")
	th, tw = tile_geom.tile_shape
	padded = []
	for tile in tiles:
		t = tile.data if isinstance(tile, enmap.ndmap) else torch.as_tensor(tile)
		padded.append(torch.nn.functional.pad(t, (0, tw - t.shape[-1], 0, th - t.shape[-2])))
	data = torch.stack(padded, -3)
	geo = tile_geom.copy()
	geo.shape = tuple(padded[0].shape[:-2]) + tuple(tile_geom.shape[-2:])
	return TileMap(data, geo)


def from_tiles(tiles, tile_geom):
	"""TileMap from a full tile list with None for inactive tiles
	(pixell_tpu.tilemap.from_tiles :314)."""
	active = [gi for gi, t in enumerate(tiles) if t is not None]
	return from_active_tiles([t for t in tiles if t is not None], tile_geom.copy(active=active))


def samegeo(arr, *args):
	"""Wrap arr with the geometry of the first TileMap in args
	(pixell_tpu.tilemap.samegeo :321)."""
	for m in args:
		if isinstance(m, TileMap):
			return TileMap(arr, m.geometry.copy())
	return arr


def make_binop(op, is_inplace=False):
	"""Binary op between TileMaps with compatible geometries, on self's
	active tiles (pixell_tpu.tilemap.make_binop :329)."""
	import operator
	if isinstance(op, str):
		op = getattr(operator, op.strip("_"), None) or getattr(torch, op)
	def binop(self, other):
		if isinstance(other, TileMap):
			if tuple(other.geometry.active) == tuple(self.geometry.active):
				return TileMap(op(self.data, other.data), self.geometry.copy())
			o2 = other.with_tiles(self.geometry.active, strict=True)
			return TileMap(op(self.data, o2.data), self.geometry.copy())
		return TileMap(op(self.data, other), self.geometry.copy())
	return binop


def insert(omap, imap, op=lambda a, b: b):
	"""Insert imap into omap (same geometry, possibly different active
	tiles); omap is not modified (pixell_tpu.tilemap.insert :345)."""
	i2 = imap.with_tiles(omap.geometry.active, strict=True)
	mask = np.isin(np.asarray(omap.geometry.active), np.asarray(imap.geometry.active))
	m = torch.from_numpy(mask).to(omap.data.device)[:, None, None]
	return TileMap(torch.where(m, op(omap.data, i2.data), omap.data), omap.geometry.copy())


def map_mul(mat, vec):
	"""Matrix multiply along the pre-axes (pixell_tpu.tilemap.map_mul :357)."""
	m = mat.data if isinstance(mat, TileMap) else torch.as_tensor(mat, device=vec.data.device)
	if m.ndim <= 2: return TileMap(m*vec.data, vec.geometry.copy())
	return TileMap(torch.einsum("ab...,b...->a...", m, vec.data), vec.geometry.copy())


def get_active_distributed(tile_map, comm):
	"""Union of the active tiles across ranks (pixell_tpu.tilemap.
	get_active_distributed :365)."""
	from . import utils
	iactive = np.zeros(tile_map.geometry.ntile, int)
	iactive[tile_map.geometry.active] = 1
	if comm is not None and getattr(comm, "size", 1) > 1:
		iactive = utils.allreduce(iactive, comm)
	return np.nonzero(iactive)[0]


class TileView:
	"""Sequence view of a TileMap's tiles (pixell_tpu.tilemap.TileView :373):
	active=True indexes the active list; active=False the full tiling
	(inactive tiles read as zero maps)."""
	def __init__(self, tmap, active=True):
		self.tmap = tmap
		self.active = active
	@property
	def ndim(self): return self.tmap.data.ndim + 1
	@property
	def shape(self): return self.tmap.geometry.shape
	def __len__(self):
		return self.tmap.nactive if self.active else self.tmap.geometry.ntile
	def __getitem__(self, i):
		if self.active:
			return self.tmap.tile(i)
		li = self.tmap.geometry.lookup[i]
		if li < 0:
			shape, wcs = self.tmap.geometry.tile_geometry(i)
			return enmap.zeros(tuple(self.tmap.pre) + tuple(shape[-2:]), wcs, self.tmap.dtype,
				device=self.tmap.device)
		return self.tmap.tile(int(li))
	def __setitem__(self, i, val):
		"""Write a tile in place."""
		if self.active: ai = i
		else:
			ai = int(self.tmap.geometry.lookup[i])
			if ai < 0: raise IndexError("tile %d is not active" % i)
		ti = self.tmap.geometry.active[ai]
		pb = self.tmap.geometry.tile_pixbox(int(ti))
		h, w = pb[1] - pb[0]
		v = val.data if isinstance(val, enmap.ndmap) else torch.as_tensor(val)
		self.tmap.data[..., ai, :h, :w] = v.to(self.tmap.data.device, self.tmap.data.dtype)
	def __iter__(self):
		for i in range(len(self)): yield self[i]


def full(tile_geom, val, dtype=np.float64, jax_array=True, *, device="cuda"):
	"""A TileMap filled with val (pixell_tpu.tilemap.full :405)."""
	out = zeros(tile_geom, dtype, jax_array=jax_array, device=device)
	return TileMap(out.data + val, out.geometry)
