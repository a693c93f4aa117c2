"""pixell_tpu_torch.distances and its kernels' plain versions against
pixell_tpu.distances on the CPU, float64, inputs from a numpy seed:

- K13's plain pass (ops/distances_core.jump_flood_plain, driven by
  ops/distances_cuda.jump_flood on CPU tensors) against the reference's
  _jump_flood at hand-picked steps that hit its traps: a step of the map's
  height or more (every row filled), a step above the width on a wrapped
  map (a shift modulo nx, not a fill), steps that are not powers of two,
  pixel seeds and a seed table, wrapped and not; distances within 1e-12
  rad and the seeds identical outside 1e-12 ties;
- shift2d against the reference's _shift2d on the same traps, exactly;
- distance_transform (with return_inds) on a full-sky map (RA wrapped);
- K14's plain version and distance_from_points' brute force (with
  domains and rmax) against the reference's blocked brute force;
- find_edges, find_edges_labeled, and the HEALPix ring helpers
  (healpix_info, unravel / ravel_healpix, get_healpix_neighs,
  find_edges_healpix, find_edges_labeled_healpix) exactly.

The reference's flood is run with jax.disable_jit(): compiled, each shape
unrolls 8 x len(steps) offsets into one XLA program (tens of seconds a shape).
labeled_distance_transform and the flood path of distance_from_points are
in test_torch_distances_flood.py, the HEALPix methods in
test_torch_distances_healpix.py.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import distances as jdist, enmap as jenmap, utils as jutils
from pixell_tpu_torch import distances, enmap
from pixell_tpu_torch.ops import distances_cuda, distances_core

TOL = 1e-12


def fullsky():
	return jenmap.fullsky_geometry(res=15*jutils.degree)          # 12 x 24, RA wrapped


def patch():
	return jenmap.geometry(pos=np.array([[-5, 5], [5, -5]])*jutils.degree, shape=(12, 24), proj="car")


def tmap(a, wcs):
	return enmap.ndmap(torch.from_numpy(np.asarray(a)), wcs)


def same_seeds(s1, s2, d1, d2):
	"""The seeds agree except where the two distances tie within TOL."""
	diff = np.asarray(s1) != np.asarray(s2)
	return np.all(np.abs(np.asarray(d1) - np.asarray(d2))[diff] <= TOL)


@pytest.mark.parametrize("sy, sx", [(13, 0), (-12, 3), (0, 50), (5, -50), (2, 24), (-1, -1), (0, 0)])
@pytest.mark.parametrize("wrapx", [True, False])
def test_shift2d(sy, sx, wrapx):
	a = np.random.default_rng(0).integers(0, 100, (12, 24))
	want = np.asarray(jdist._shift2d(jax.numpy.asarray(a), sy, sx, wrapx, -1))
	got = distances_core.shift2d(torch.from_numpy(a), sy, sx, wrapx, -1)
	assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("geo, table", [(fullsky, False), (fullsky, True), (patch, False), (patch, True)])
def test_flood_passes(geo, table):
	"""The whole flood at steps that hit the traps against the reference's
	_jump_flood; the reference's state carries (dec, ra, label), the port's
	the seed index, whose label is itself."""
	shape, wcs = geo()
	rng = np.random.default_rng(1)
	pos = np.asarray(jenmap.posmap(shape, wcs, safe=False))
	n = int(np.prod(shape))
	pick = rng.choice(n, 7, replace=False)
	if table:
		tdec, tra = rng.uniform(-1.3, 1.3, 7), rng.uniform(-np.pi, np.pi, 7)
		lab = np.arange(7)
	else:
		tdec, tra = pos[0].reshape(-1)[pick], pos[1].reshape(-1)[pick]
		lab = pick
	sd = np.full(n, 1e30); sr = np.zeros(n); sl = np.full(n, -1.0)
	sd[pick], sr[pick], sl[pick] = tdec, tra, lab
	wrapx = jdist._is_wrapx(shape, wcs)
	steps = (64, 50, 13, 7, 3, 2, 1)
	with jax.disable_jit():
		ref = jdist._jump_flood(*(jax.numpy.asarray(a.reshape(shape)) for a in (sd, sr, sl)),
			jax.numpy.asarray(pos[0]), jax.numpy.asarray(pos[1]), wrapx, steps)
	seed = torch.full((n,), -1, dtype=torch.int32)
	seed[torch.from_numpy(pick)] = torch.from_numpy(np.arange(7) if table else pick).to(torch.int32)
	s, d = distances_cuda.jump_flood(seed.reshape(shape), *distances._positions(shape, wcs, "cpu"), wrapx, steps,
		(torch.from_numpy(tdec), torch.from_numpy(tra)) if table else None)
	rd, rl = np.asarray(ref[3]), np.asarray(ref[2])
	assert np.max(np.abs(d.numpy() - rd)) <= TOL
	assert same_seeds(s.numpy(), rl, d.numpy(), rd)   # a seed's label is its index in both
	assert distances_cuda.LAUNCHES["jump_flood"] == 0   # CPU tensors take the plain version


@pytest.mark.parametrize("geo, table", [(fullsky, False), (patch, True)])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_pass_and_finish_twins(geo, table, k):
	"""K13's plain pass (jump_flood_plain, the seed alone as the state) run
	pass by pass over the first k trap steps and then its finish
	(flood_finish_plain) against the reference's _jump_flood over the same
	steps; k = 0: the finish of the seeds themselves against the
	reference's initial distances. A pass leaves its input as it was."""
	shape, wcs = geo()
	rng = np.random.default_rng(6 + k)
	pos = np.asarray(jenmap.posmap(shape, wcs, safe=False))
	n = int(np.prod(shape))
	pick = rng.choice(n, 6, replace=False)
	if table:
		tdec, tra = rng.uniform(-1.3, 1.3, 6), rng.uniform(-np.pi, np.pi, 6)
		lab, tab = np.arange(6), (torch.from_numpy(tdec), torch.from_numpy(tra))
	else:
		tdec, tra, lab, tab = pos[0].reshape(-1)[pick], pos[1].reshape(-1)[pick], pick, None
	sd = np.full(n, 1e30); sr = np.zeros(n); sl = np.full(n, -1.0)
	sd[pick], sr[pick], sl[pick] = tdec, tra, lab
	wrapx = jdist._is_wrapx(shape, wcs)
	steps = (64, 50, 13, 7, 3, 2, 1)[:k]
	with jax.disable_jit():
		ref = jdist._jump_flood(*(jax.numpy.asarray(a.reshape(shape)) for a in (sd, sr, sl)),
			jax.numpy.asarray(pos[0]), jax.numpy.asarray(pos[1]), wrapx, steps)
	seed = torch.full((n,), -1, dtype=torch.int64)
	seed[torch.from_numpy(pick)] = torch.from_numpy(lab)
	s = seed.reshape(shape)
	pd, pr = distances._positions(shape, wcs, "cpu")
	for step in steps:
		for dy, dx in distances_cuda.OFFSETS:
			before = s.clone()
			out = distances_core.jump_flood_plain(s, pd, pr, tab, dy*step, dx*step, wrapx)
			assert out is not s and torch.equal(s, before)
			s = out
	d = distances_core.flood_finish_plain(s, pd, pr, tab)
	rd, rl = np.asarray(ref[3]), np.asarray(ref[2])
	assert np.max(np.abs(d.numpy() - rd)) <= TOL
	assert same_seeds(s.numpy(), rl, d.numpy(), rd)
	assert torch.equal(d == distances_core.BIG, s < 0)


def test_flood_index_dtypes():
	"""int64 seeds give the int32 seeds' flood."""
	shape, wcs = patch()
	n = int(np.prod(shape))
	pick = np.random.default_rng(2).choice(n, 5, replace=False)
	seed = torch.full((n,), -1, dtype=torch.int64)
	seed[torch.from_numpy(pick)] = torch.from_numpy(pick)
	pd, pr = distances._positions(shape, wcs, "cpu")
	s64, d64 = distances_cuda.jump_flood(seed.reshape(shape), pd, pr, False, (16, 4, 1))
	s32, d32 = distances_cuda.jump_flood(seed.reshape(shape).to(torch.int32), pd, pr, False, (16, 4, 1))
	assert s64.dtype == torch.int64 and s32.dtype == torch.int32
	assert torch.equal(s64, s32.to(torch.int64)) and torch.equal(d64, d32)


def test_flood_checks():
	pd, pr = distances._positions(*patch(), "cpu")
	with pytest.raises(ValueError):
		distances_cuda.jump_flood(torch.zeros((12, 24), dtype=torch.float64), pd, pr, False, (1,))
	with pytest.raises(ValueError):
		distances_cuda.nearest_point(pd, pr, torch.zeros(3, dtype=torch.float32), torch.zeros(3), (12, 24))


@pytest.mark.parametrize("geo", [fullsky, patch])
def test_distance_transform(geo):
	shape, wcs = geo()
	mask = np.random.default_rng(3).uniform(size=shape) > 0.04
	with jax.disable_jit():
		d1, i1 = jdist.distance_transform(jenmap.ndmap(mask, wcs), return_inds=True)
		d3 = jdist.distance_transform(jenmap.ndmap(mask, wcs), rmax=0.2)
	d2, i2 = distances.distance_transform(tmap(mask, wcs), return_inds=True)
	d4 = distances.distance_transform(tmap(mask, wcs), rmax=0.2)
	assert isinstance(d2, enmap.ndmap) and d2.dtype == torch.float64 and i2.dtype == torch.int64
	assert np.max(np.abs(d2.data.numpy() - np.asarray(d1))) <= TOL
	assert np.max(np.abs(d4.data.numpy() - np.asarray(d3))) <= TOL
	i1 = np.asarray(i1)
	diff = np.any(i2.numpy() != i1, 0)
	# a differing index is a tie: the two pixels lie equally far
	pos = np.asarray(jenmap.posmap(shape, wcs, safe=False))
	for y, x in zip(*np.nonzero(diff)):
		a = pos[:, i1[0, y, x], i1[1, y, x]]; b = pos[:, i2[0, y, x], i2[1, y, x]]
		da = jutils.angdist(np.array([pos[1, y, x], pos[0, y, x]]), np.array([a[1], a[0]]))
		db = jutils.angdist(np.array([pos[1, y, x], pos[0, y, x]]), np.array([b[1], b[0]]))
		assert abs(da - db) <= TOL


def test_distance_transform_no_seed():
	"""A mask with no False pixel: the reference's BIG distances and the
	index (-1, nx - 1) of the seed -1."""
	shape, wcs = patch()
	d, inds = distances.distance_transform(tmap(np.ones(shape, bool), wcs), return_inds=True)
	assert torch.all(d.data == distances_core.BIG)
	assert torch.all(inds[0] == -1) and torch.all(inds[1] == shape[1] - 1)


@pytest.mark.parametrize("npt", [1, 200, 1024])
def test_distance_from_points_brute(npt):
	shape, wcs = fullsky()
	rng = np.random.default_rng(4 + npt)
	pts = np.array([rng.uniform(-1.4, 1.4, npt), rng.uniform(-np.pi, np.pi, npt)])
	d1, m1 = jdist.distance_from_points(shape, wcs, pts, domains=True, rmax=0.3)
	d2, m2 = distances.distance_from_points(shape, wcs, pts, domains=True, rmax=0.3, device="cpu")
	assert m2.dtype == torch.int32
	assert np.max(np.abs(d2.data.numpy() - np.asarray(d1))) <= TOL
	assert same_seeds(m2.data.numpy(), np.asarray(m1), d2.data.numpy(), np.asarray(d1))
	e1 = jdist.distance_from_points(shape, wcs, pts)
	e2 = distances.distance_from_points(shape, wcs, torch.from_numpy(pts))   # a tensor's device
	assert np.max(np.abs(e2.data.numpy() - np.asarray(e1))) <= TOL


def test_nearest_point_plain():
	"""K14's plain version: the first index of the minimum, BIG and 0
	without points, positions broadcast from the axes."""
	shape, wcs = patch()
	pd, pr = distances._positions(shape, wcs, "cpu")
	pts = torch.tensor([[0.01, 0.01, -0.02], [0.02, 0.02, 0.03]], dtype=torch.float64)
	d, dom = distances_cuda.nearest_point(pd, pr, pts[0], pts[1], shape)
	assert torch.all(dom != 1)   # 1 repeats 0: the first wins
	d0, dom0 = distances_cuda.nearest_point(pd, pr, pts[0, :0], pts[1, :0], shape)
	assert torch.all(d0 == distances_core.BIG) and torch.all(dom0 == 0)
	pos = np.asarray(jenmap.posmap(shape, wcs, safe=False))
	want = np.min([jutils.angdist(np.array([pos[1], pos[0]]),
		np.array([pts[1, i].item(), pts[0, i].item()])[:, None, None]) for i in range(3)], 0)
	assert np.max(np.abs(d.numpy() - want)) <= TOL


def test_find_edges():
	shape, wcs = fullsky()
	rng = np.random.default_rng(5)
	mask = rng.uniform(size=shape) > 0.3
	labels = rng.integers(0, 4, shape)
	assert np.array_equal(distances.find_edges(tmap(mask, wcs)).data.numpy(),
		np.asarray(jdist.find_edges(jenmap.ndmap(mask, wcs))))
	assert np.array_equal(distances.find_edges_labeled(tmap(labels, wcs)).data.numpy(),
		np.asarray(jdist.find_edges_labeled(jenmap.ndmap(labels, wcs))))
	assert np.array_equal(distances.find_edges(torch.from_numpy(mask)).numpy(), np.asarray(jdist.find_edges(mask)))


@pytest.mark.parametrize("nside", [1, 4, 16])
def test_healpix_helpers(nside):
	ji, ti = jdist.healpix_info(nside), distances.healpix_info(nside)
	for k in ("nside", "npix", "ny", "nx", "off", "ra0", "dec", "cos_dec", "sin_dec", "shift"):
		assert np.array_equal(np.asarray(getattr(ti, k)), np.asarray(getattr(ji, k))), k
	rng = np.random.default_rng(nside)
	pix = rng.integers(0, ti.npix, 50)
	p2 = distances.unravel_healpix(ti, pix)
	assert np.array_equal(p2, jdist.unravel_healpix(ji, pix))
	assert np.array_equal(distances.ravel_healpix(ti, p2), pix)
	for y, x in p2.T[:10]:
		assert np.array_equal(distances.get_healpix_neighs(ti, y, x), jdist.get_healpix_neighs(ji, y, x))
	mask = rng.uniform(size=ti.npix) > 0.7
	labels = rng.integers(0, 3, ti.npix)
	for flat in (True, False):
		assert np.array_equal(distances.find_edges_healpix(ti, torch.from_numpy(mask), flat=flat),
			jdist.find_edges_healpix(ji, mask, flat=flat))
		assert np.array_equal(distances.find_edges_labeled_healpix(ti, labels, flat=flat),
			jdist.find_edges_labeled_healpix(ji, labels, flat=flat))
