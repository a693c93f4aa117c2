"""pixell_tpu_torch.tilemap against pixell_tpu.tilemap on the same numpy
maps, and its distribution on two gloo ranks.

- One process: TileGeometry (grid, lookup, pixel boxes, tile geometries,
  copy with add_active, compatible, size), the constructors (zeros, empty,
  full, from_enmap, from_tiles, from_active_tiles) and operations
  (to_enmap, with_tiles, insert, map_mul, make_binop, samegeo, the
  TileView views and their writes, arithmetic) equal to the reference's
  exactly (they move numbers, they compute nothing but the products, 1e-15);
  write_map / read_map against the reference's: each reads the other's
  file to the same tiles, and the files' bytes are equal.
- Two ranks (tests/torch_dist_worker.py, no JAX): distribute shards the
  tile axis (each rank holds its share, the count padded to a multiple of
  the ranks, as the reference's distribute pads it), redistribute to
  Replicate gathers it and back shards it again, to_enmap of the result is
  the map, reduce and tree_reduce sum the ranks' maps, and
  get_active_distributed unites the ranks' active sets; the communicators
  at two ranks too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import torch_dist_worker as W
from pixell_tpu import tilemap as jtilemap, enmap as jenmap, utils as jutils
from pixell_tpu_torch import tilemap, enmap, utils

TILE = (16, 16)


def host(x):
	if isinstance(x, tilemap.TileMap): x = x.data
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().numpy()
	return np.asarray(x)


def same(got, want):
	got, want = host(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max() <= 1e-15*max(np.abs(want).max(), 1)


@pytest.fixture(scope="module")
def maps():
	(js, jw), (ps, pw) = (m.fullsky_geometry(res=3*utils.degree) for m in (jenmap, enmap))
	d = np.random.default_rng(5).standard_normal((2,) + js)
	return jenmap.ndmap(d, jw), enmap.ndmap(torch.from_numpy(d), pw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
	return W.spawn(tmp_path_factory.mktemp("ranks"), ["tilemap", "comm"], world=2).result()


def test_geometry(maps):
	jm, pm = maps
	jg, pg = jtilemap.geometry(jm.shape, jm.wcs, TILE, active=[0, 3, 5]), \
		tilemap.geometry(pm.shape, pm.wcs, TILE, active=[0, 3, 5])
	assert pg.grid_shape == jg.grid_shape and pg.ntile == jg.ntile and pg.nactive == 3
	np.testing.assert_array_equal(pg.lookup, jg.lookup)
	assert pg.size == jg.size and pg.pre == jg.pre
	for ti in (0, 5, pg.ntile - 1):
		np.testing.assert_array_equal(pg.tile_pixbox(ti), jg.tile_pixbox(ti))
		assert pg.tile_geometry(ti)[0] == jg.tile_geometry(ti)[0]
		assert pg.tiles[ti][1].wcs.crpix.tolist() == jg.tiles[ti][1].wcs.crpix.tolist()
	assert pg.grid2ind(*pg.ind2grid(7)) == 7 == jg.grid2ind(*jg.ind2grid(7))
	np.testing.assert_array_equal(pg.copy(add_active=[5, 9, 2]).active, jg.copy(add_active=[5, 9, 2]).active)
	assert pg.compatible(pg) == 2 and pg.compatible(pg.copy(active=[1])) == 1
	assert pg.compatible(tilemap.geometry(pm.shape, pm.wcs, (8, 8))) == 0
	assert repr(pg).startswith("TileGeometry")


@pytest.mark.parametrize("active", [None, [0, 3, 5, 11]])
def test_from_to_enmap(maps, active):
	jm, pm = maps
	jt, pt = jtilemap.from_enmap(jm, TILE, active), tilemap.from_enmap(pm, TILE, active)
	assert same(pt, jt.data)
	assert same(pt.to_enmap(), jt.to_enmap()) and same(tilemap.to_enmap(pt), jtilemap.to_enmap(jt))
	for i in range(min(3, pt.nactive)):
		assert same(pt.active_tiles[i], jt.active_tiles[i])
	assert same(pt.tiles[1], jt.tiles[1])   # inactive where active is given: zeros
	assert len(pt.tiles) == pt.ntile and len(pt.active_tiles) == pt.nactive
	assert same(pt.contig(), jt.contig().data)


def test_constructors(maps, tmp_path):
	jm, pm = maps
	jg, pg = jtilemap.geometry(jm.shape, jm.wcs, TILE), tilemap.geometry(pm.shape, pm.wcs, TILE)
	assert same(tilemap.zeros(pg, device="cpu"), jtilemap.zeros(jg).data)
	assert same(tilemap.empty(pg, device="cpu"), jtilemap.empty(jg).data)
	assert same(tilemap.full(pg, 2.5, device="cpu"), jtilemap.full(jg, 2.5).data)
	assert tilemap.zeros(pg, np.float32, jax_array=False, device="cpu").dtype == torch.float32
	jt, pt = jtilemap.from_enmap(jm, TILE), tilemap.from_enmap(pm, TILE)
	jtiles = [jt.active_tiles[i] for i in range(4)]
	ptiles = [pt.active_tiles[i] for i in range(4)]
	a4 = jg.copy(active=[0, 1, 2, 3])
	assert same(tilemap.from_active_tiles(ptiles, pg.copy(active=[0, 1, 2, 3])),
		jtilemap.from_active_tiles(jtiles, a4).data)
	full_j = [jtiles[0], None, jtiles[2]] + [None]*(jg.ntile - 3)
	full_p = [ptiles[0], None, ptiles[2]] + [None]*(pg.ntile - 3)
	fj, fp = jtilemap.from_tiles(full_j, jg), tilemap.from_tiles(full_p, pg)
	assert same(fp, fj.data) and list(fp.active) == list(fj.active) == [0, 2]
	with pytest.raises(ValueError):
		tilemap.from_active_tiles(ptiles[:2], pg.copy(active=[0, 1, 2]))
	assert tilemap.samegeo(pt.data, 3, pt).geometry.nactive == pt.nactive
	p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
	tilemap.write_map(p, fp)
	jtilemap.write_map(r, fj)
	assert open(p, "rb").read() == open(r, "rb").read()
	assert same(tilemap.read_map(r, TILE, device="cpu"), jtilemap.read_map(p, TILE).data)


def test_operations(maps):
	jm, pm = maps
	jt, pt = jtilemap.from_enmap(jm, TILE, [0, 3, 5]), tilemap.from_enmap(pm, TILE, [0, 3, 5])
	for other in ([0, 1, 3, 5], [3, 0]):
		for strict in (False, True):
			w1, w2 = jt.with_tiles(np.array(other), strict=strict), pt.with_tiles(np.array(other), strict=strict)
			assert same(w2, w1.data) and list(w2.active) == list(w1.active)
	ja, pa = jtilemap.from_enmap(jm*2, TILE, [3, 7]), tilemap.from_enmap(pm*2, TILE, [3, 7])
	assert same(tilemap.insert(pt, pa), jtilemap.insert(jt, ja).data)
	assert same(pt.insert(pa, op=lambda a, b: a + b), jt.insert(ja, op=lambda a, b: a + b).data)
	mat = np.random.default_rng(2).standard_normal((2, 2) + tuple(host(pt).shape[-3:]))
	jmat, pmat = jtilemap.TileMap(mat, jt.geometry), tilemap.TileMap(torch.from_numpy(mat), pt.geometry)
	assert same(tilemap.map_mul(pmat, pt), jtilemap.map_mul(jmat, jt).data)
	w = np.linspace(0, 1, 16)[:, None]*np.ones(16)
	assert same(tilemap.map_mul(w, pt), jtilemap.map_mul(w, jt).data)
	for op in ("__add__", "__mul__", "sub"):
		got = tilemap.make_binop(op)(pt, pa)
		assert same(got, jtilemap.make_binop(op)(jt, ja).data)
		assert same(tilemap.make_binop(op)(pt, 3.0), jtilemap.make_binop(op)(jt, 3.0).data)
	assert same(pt + pt, (jt + jt).data) and same(pt*2, (jt*2).data) and same(pt - pt, (jt - jt).data)
	pv, jv = pt.copy(), jt.copy()
	pv.active_tiles[0] = host(pt.active_tiles[0])*0 + 7
	jv.active_tiles[0] = np.asarray(jt.active_tiles[0])*0 + 7
	pv.tiles[5] = torch.ones(2, 16, 16)
	jv.tiles[5] = np.ones((2, 16, 16))
	assert same(pv, jv.data)
	with pytest.raises(IndexError):
		pv.tiles[1] = torch.ones(2, 16, 16)
	np.testing.assert_array_equal(tilemap.get_active_distributed(pt, None),
		jtilemap.get_active_distributed(jt, None))


def test_distributed(maps, ranks):
	"""Two ranks: each holds its half of the tiles, Replicate gathers them,
	the map comes back, reduce sums the ranks' (rank + 1) maps, and the
	active sets unite."""
	_, pm = maps
	pt = tilemap.from_enmap(pm, TILE)
	n = pt.nactive
	assert int(ranks["tilemap/r2/local_tiles"]) == -(-n//2)
	padded = np.concatenate([host(pt), np.zeros((2, n % 2, 16, 16))], -3)
	assert same(ranks["tilemap/r2/distributed"], padded)
	assert same(ranks["tilemap/r2/replicated_local"], padded)
	assert int(ranks["tilemap/r2/back_local_tiles"]) == -(-n//2)
	assert same(ranks["tilemap/r2/to_enmap"], host(pm))
	assert same(ranks["tilemap/reduce"], 3*host(pt)) and same(ranks["tilemap/tree_reduce"], 3*host(pt))
	np.testing.assert_array_equal(ranks["tilemap/active_union"], [0, 1, 10, 11])


def test_communicators_two_ranks(ranks):
	r = lambda k: ranks["comm/" + k]
	v = np.arange(5.)[None] + np.arange(2)[:, None]
	assert int(r("size")) == 2 and bool(r("world_type"))
	np.testing.assert_array_equal(r("sum"), v.sum(0))
	np.testing.assert_array_equal(r("max"), v.max(0))
	np.testing.assert_array_equal(r("min"), v.min(0))
	np.testing.assert_array_equal(r("gather"), v)
	np.testing.assert_array_equal(r("bcast"), [17])
	np.testing.assert_array_equal(r("complex_sum"), np.full(3, complex(1, -2)))
