"""The binning of the NUFFT point stage (ops.nufft_core.bin_points), which
K10 and K11 take on the card, on the CPU with small shapes and no JAX: for
float32 and float64 fractions, on points outside one period, a ragged grid,
a grid smaller than one padded tile, an f32 fraction that rounds to 1.0 and
a tile holding several times cap points,

- the permutation sorts the points by tile, ties in the original order;
- every subproblem holds at most cap points of one tile, and the
  subproblems cover the points once;
- every tap of every point, as nufft_core.taps places it, lies in its
  subproblem's padded tile modulo the grid;
- the twins run subproblem by subproblem through the permutation give the
  unbinned twins' results (u2nu_points_plain exactly, nu2u_spread_plain
  within 1e-13 in float64);

and the first taps against the kernels' arithmetic written in numpy, the
tile keys (the twin of K12) and their format, the wrappers' component plan,
the cache of bins per point set, and the arguments the wrappers launch
with.
"""
import ctypes

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu_torch.ops import nufft_core, nufft_cuda

PER = (2*np.pi, 5.0)


def case_points(name, rng):
	"""(coords [npt, 2] float64, nfine, w, tile, cap) of the named case."""
	if name == "outside":      # points outside one period and on its edges
		co = np.stack([rng.uniform(-7, 13, 700), rng.uniform(-5, 11, 700)], -1)
		co[:3, 0] = [0.0, 2*np.pi, -1e-300]
		return co, (64, 96), 7, (32, 32), 100
	if name == "ragged":       # sizes that are not multiples of the tile
		return rng.uniform(0, 1, (600, 2))*PER, (45, 70), 11, (16, 32), 64
	if name == "small":        # the grid smaller than one padded tile
		return rng.uniform(-1, 7, (300, 2)), (20, 24), 16, (32, 32), 1024
	if name == "rounds_up":    # f32 fractions that round to 1.0: the first tap moves by one at even w
		k = rng.integers(0, 40, (200, 2))
		co = (k - 1e-9*rng.uniform(0.5, 1, (200, 2)))/np.array([40, 50])*PER
		return co, (40, 50), 8, (16, 16), 32
	if name == "pile_up":      # one tile holding several times cap points
		co = rng.uniform(0, 1, (900, 2))*PER
		co[:700] = [1.0, 2.0] + rng.uniform(0, 1e-3, (700, 2))
		return co, (64, 64), 7, (16, 16), 128
	raise KeyError(name)


CASES = ("outside", "ragged", "small", "rounds_up", "pile_up")
DTYPES = (torch.float32, torch.float64)


def binned(name, dtype, seed=0):
	rng = np.random.default_rng(seed)
	co, nfine, w, tile, cap = case_points(name, rng)
	co = torch.from_numpy(co)
	return co, nfine, w, tile, cap, nufft_core.bin_points(co, nfine, PER, w, dtype, tile, cap)


def first_tap_numpy(co, nfine, w, dtype):
	"""The kernels' point_axis (csrc/nufft.cu) in numpy, IEEE float64 and
	dtype: t = c/per, t - floor(t), times n; fraction cast; base + floor(f -
	w/2) + 1, wrapped."""
	out = []
	for a in range(2):
		t = co[:, a]/PER[a]
		t = t - np.floor(t)
		p = t*float(nfine[a])
		b = np.floor(p)
		f = (p - b).astype(dtype)
		tf = np.floor(f - dtype(w/2))
		out.append(np.mod(b.astype(np.int64) + tf.astype(np.int64) + 1, nfine[a]))
	return np.stack(out, -1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_first_taps_are_the_kernels_and_taps(name, dtype):
	co, nfine, w, _, _, _ = binned(name, dtype)
	got = nufft_core.first_taps(co, nfine, PER, w, dtype).numpy()
	npd = np.float32 if dtype == torch.float32 else np.float64
	assert np.array_equal(got, first_tap_numpy(co.numpy(), nfine, w, npd))
	for a, ((b, f), n) in enumerate(zip(nufft_core.split_positions(co, nfine, PER), nfine)):
		idx, _ = nufft_core.taps(b, f, w, 2.3*w, n, dtype)
		assert torch.equal(idx[:, 0], torch.from_numpy(got[:, a]))


def test_rounding_case_moves_first_taps():
	"""The rounds_up case does what it is for: in float32 some first taps
	lie one cell after float64's."""
	co, nfine, w, _, _, _ = binned("rounds_up", torch.float32)
	d = nufft_core.first_taps(co, nfine, PER, w, torch.float32) \
		- nufft_core.first_taps(co, nfine, PER, w, torch.float64)
	d = torch.remainder(d, torch.tensor(nfine))
	assert bool(((d == 0) | (d == 1)).all()) and int((d == 1).sum()) > 50


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_permutation_is_stable(name, dtype):
	co, nfine, w, tile, _, bins = binned(name, dtype)
	npt = co.shape[0]
	perm = bins.perm
	assert torch.equal(torch.sort(perm).values, torch.arange(npt))
	first = nufft_core.first_taps(co, nfine, PER, w, dtype)
	ntx = bins.ntiles[1]
	tiles = (first[:, 0]//tile[0])*ntx + first[:, 1]//tile[1]
	k = tiles[perm]
	assert bool((k[1:] >= k[:-1]).all())
	ties = k[1:] == k[:-1]
	assert bool((perm[1:][ties] > perm[:-1][ties]).all())
	assert torch.equal(bins.counts, torch.bincount(tiles, minlength=bins.ntiles[0]*ntx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_tile_keys(name, dtype):
	"""The keys are the tiles of the first taps, int16 less 32768 (the
	tiles' order kept) up to 65536 tiles, int32 beyond; bin_points on given
	keys is bin_points on its own."""
	co, nfine, w, tile, cap, bins = binned(name, dtype)
	keys = nufft_core.tile_keys(co, nfine, PER, w, dtype, tile)
	first = nufft_core.first_taps(co, nfine, PER, w, dtype)
	tiles = (first[:, 0]//tile[0])*bins.ntiles[1] + first[:, 1]//tile[1]
	assert keys.dtype == torch.int16 and torch.equal(keys.long() + 32768, tiles)
	again = nufft_core.bin_points(co, nfine, PER, w, dtype, tile, cap, keys=keys)
	assert all(torch.equal(a, b) for a, b in zip(again[:3], bins[:3]))
	assert nufft_core.key_format(1 << 16) == (torch.int16, 32768)
	assert nufft_core.key_format((1 << 16) + 1) == (torch.int32, 0)
	wide = nufft_core.tile_keys(co, nfine, PER, w, dtype, (1, 1))
	assert wide.dtype == (torch.int32 if nfine[0]*nfine[1] > 1 << 16 else torch.int16)


def test_many_tiles():
	"""Past 65536 tiles the keys are int32 and the bins the same."""
	rng = np.random.default_rng(4)
	co = torch.from_numpy(rng.uniform(0, 1, (3000, 2))*PER)
	nfine, tile = (300, 700), (1, 3)
	keys = nufft_core.tile_keys(co, nfine, PER, 5, torch.float64, tile)
	assert keys.dtype == torch.int32
	bins = nufft_core.bin_points(co, nfine, PER, 5, torch.float64, tile, 4)
	first = nufft_core.first_taps(co, nfine, PER, 5, torch.float64)
	tiles = (first[:, 0]//tile[0])*bins.ntiles[1] + first[:, 1]//tile[1]
	assert torch.equal(keys.long(), tiles)
	n = int((bins.subs[:, 2] > bins.subs[:, 1]).sum())
	for t, s, e in bins.subs[:n].tolist():
		assert bool((tiles[bins.perm[s:e]] == t).all()) and e - s <= 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_subproblems_cover_one_tile_each(name, dtype):
	co, nfine, w, tile, cap, bins = binned(name, dtype)
	npt = co.shape[0]
	nty, ntx = bins.ntiles
	assert (nty, ntx) == (-(-nfine[0]//tile[0]), -(-nfine[1]//tile[1]))
	first = nufft_core.first_taps(co, nfine, PER, w, dtype)
	tiles = (first[:, 0]//tile[0])*ntx + first[:, 1]//tile[1]
	subs = bins.subs
	assert subs.shape == (npt//cap + min(nty*ntx, npt), 3)
	live = subs[:, 2] > subs[:, 1]
	n = int(live.sum())
	assert bool(live[:n].all()) and not bool(live[n:].any())
	assert bool((subs[n:, 1:] == npt).all())
	assert int(subs[0, 1]) == 0 and int(subs[n - 1, 2]) == npt
	assert torch.equal(subs[1:n, 1], subs[:n - 1, 2])
	assert int((subs[:n, 2] - subs[:n, 1]).max()) <= cap
	assert n == int(((bins.counts + cap - 1)//cap).sum())
	for t, s, e in subs[:n].tolist():
		assert bool((tiles[bins.perm[s:e]] == t).all())
	if name == "pile_up":
		assert int(bins.counts.max()) > 4*cap


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_taps_lie_in_the_padded_tile(name, dtype):
	co, nfine, w, tile, _, bins = binned(name, dtype)
	ntx = bins.ntiles[1]
	pos = nufft_core.split_positions(co, nfine, PER)
	iy, _ = nufft_core.taps(*pos[0], w, 2.3*w, nfine[0], dtype)
	ix, _ = nufft_core.taps(*pos[1], w, 2.3*w, nfine[1], dtype)
	for t, s, e in bins.subs.tolist():
		if s == e: continue
		pts = bins.perm[s:e]
		for idx, corner, T, n in ((iy, (t//ntx)*tile[0], tile[0], nfine[0]),
				(ix, (t % ntx)*tile[1], tile[1], nfine[1])):
			padded = torch.remainder(corner + torch.arange(T + w - 1), n)
			assert bool(torch.isin(idx[pts], padded).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_twins_by_subproblem(name, dtype):
	"""The twins through the permutation, subproblem by subproblem, against
	the unbinned twins: u2nu_points_plain exactly, nu2u_spread_plain within
	1e-13 in float64 (1e-5 in float32)."""
	co, nfine, w, _, _, bins = binned(name, dtype)
	rng = np.random.default_rng(1)
	fine = torch.from_numpy(rng.standard_normal((2,) + nfine)).to(dtype)
	beta = 2.3*w
	want = nufft_core.u2nu_points_plain(fine, co, PER, w, beta)
	got = torch.empty_like(want)
	spread = torch.zeros_like(fine)
	for _, s, e in bins.subs.tolist():
		if s == e: continue
		pts = bins.perm[s:e]
		got[:, pts] = nufft_core.u2nu_points_plain(fine, co[pts].contiguous(), PER, w, beta)
		spread += nufft_core.nu2u_spread_plain(want[:, pts], co[pts].contiguous(), nfine, PER, w, beta)
	assert torch.equal(got, want)
	ref = nufft_core.nu2u_spread_plain(want, co, nfine, PER, w, beta)
	tol = 1e-13 if dtype == torch.float64 else 1e-5
	assert float((spread - ref).abs().max()/ref.abs().max()) < tol


class PlanLib:
	"""The two entry points of the built library that components reads, on
	the CPU: pt_nufft_point_cmax, and pt_nufft_smem_bytes with csrc/nufft.cu's
	layout (K10 the padded tile of cc components; K11 the same with its
	weight rows [2 w][33], value rows [cc r][33] and 32 int offsets)."""
	def pt_nufft_point_cmax(self): return 4

	def pt_nufft_smem_bytes(self, spread, f64, cplx, cc, w, ty, tx):
		e, r = (8 if f64 else 4), (2 if cplx else 1)
		tile = cc*(ty + w - 1)*(tx + w - 1)*r*e
		return tile + ((2*w + cc*r)*33*e + 128 if spread else 0)


def test_component_plan():
	"""components: the most components whose block, as the library counts
	its shared memory, fits the kernel's budget, at least one, for K10 at
	most the library's pt_nufft_point_cmax."""
	lib = PlanLib()
	seen = set()
	for spread, budget in ((False, nufft_cuda.POINTS_SMEM), (True, nufft_cuda.SPREAD_SMEM)):
		for esize in (4, 8):
			for r in (1, 2):
				for w in (2, 7, 11, 16):
					for C in (1, 3, 8):
						smem = lambda cc: lib.pt_nufft_smem_bytes(spread, esize == 8, r == 2, cc, w,
							*nufft_cuda.TILE)
						cc = nufft_cuda.components(spread, C, esize, r, w, lib)
						seen.add(cc)
						assert 1 <= cc <= C
						assert cc == 1 or smem(cc) <= budget
						most = C if spread else min(C, lib.pt_nufft_point_cmax())
						assert cc <= most
						assert cc == most or smem(cc + 1) > budget
						assert smem(cc) <= 232448
	assert {1, 2, 3, 4} <= seen


def bins_args(seed=3, npt=400):
	rng = np.random.default_rng(seed)
	return torch.from_numpy(rng.uniform(-1, 7, (npt, 2))), (40, 72), PER, 7


@pytest.mark.parametrize("dtype", DTYPES)
def test_bins_cache(dtype, monkeypatch):
	"""bins bins a point set once: again for the same coords, or another
	view of their memory, it returns the same Bins; another width, dtype
	or grid, an in-place write to the points, or points in other memory
	are binned anew; the cache keeps BINS_CACHE point sets and a reference
	to each one's coords; what it returns is bin_points' result."""
	nufft_cuda.clear_bins()
	real = nufft_core.bin_points
	calls = []
	monkeypatch.setattr(nufft_core, "bin_points", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
	co, nfine, per, w = bins_args()

	def same(b, co, nfine=nfine, w=w, dtype=dtype):
		want = real(co, nfine, per, w, dtype, nufft_cuda.TILE, nufft_cuda.CAP)
		return all(torch.equal(x, y) for x, y in zip(b[:3], want[:3])) and b.ntiles == want.ntiles

	b = nufft_cuda.bins(co, nfine, per, w, dtype)
	assert same(b, co) and len(calls) == 1
	assert nufft_cuda.bins(co, nfine, per, w, dtype) is b
	assert nufft_cuda.bins(co.reshape(-1, 2), nfine, per, w, dtype) is b
	assert nufft_cuda.bins(co[:], nfine, per, w, dtype) is b
	assert len(calls) == 1
	assert any(v[0] is co for v in nufft_cuda._BINS.values())
	other = torch.float32 if dtype == torch.float64 else torch.float64
	for args in ((nfine, per, w + 2, dtype), (nfine, per, w, other), ((48, 72), per, w, dtype)):
		assert nufft_cuda.bins(co, *args) is not b
		assert len(nufft_cuda._BINS) <= nufft_cuda.BINS_CACHE
	assert len(calls) == 4
	co[:50] += 0.7
	b2 = nufft_cuda.bins(co, nfine, per, w, dtype)
	assert b2 is not b and same(b2, co) and len(calls) == 5
	copy = co.clone()
	assert nufft_cuda.bins(copy, nfine, per, w, dtype) is not b2 and len(calls) == 6
	assert nufft_cuda.bins(co, nfine, per, w, dtype) is b2 and len(calls) == 6
	with torch.inference_mode():
		ci = co.clone()
	assert same(nufft_cuda.bins(ci, nfine, per, w, dtype), ci) and len(calls) == 7
	assert nufft_cuda.bins(ci, nfine, per, w, dtype) is not nufft_cuda.bins(ci, nfine, per, w, dtype)
	nufft_cuda.clear_bins()
	assert not nufft_cuda._BINS


def test_wrappers_share_bins(monkeypatch):
	"""K10 and K11 at the same points, grid, width and dtype: K12 and the
	sort run once, and both launches take the same bins."""
	nufft_cuda.clear_bins()
	co, nfine, per, w = bins_args(5)
	calls = []

	def call(n, dev, *args):
		calls.append((n, args))
		if n == "tile_keys":
			want = nufft_core.tile_keys(co, nfine, per, w, torch.float64, nufft_cuda.TILE)
			ctypes.memmove(args[3], want.data_ptr(), want.numel()*want.element_size())

	monkeypatch.setattr(nufft_cuda, "library", PlanLib)
	monkeypatch.setattr(nufft_cuda, "_on_card", lambda x: True)
	monkeypatch.setattr(nufft_cuda, "_stream", lambda x: 0)
	monkeypatch.setattr(nufft_cuda, "_call", call)
	nufft_cuda.reset_launches()
	fine = torch.zeros((2,) + nfine, dtype=torch.float64)
	vals = torch.zeros((2, co.shape[0]), dtype=torch.float64)
	nufft_cuda.u2nu_points(fine, co, per, w, 16.1)
	nufft_cuda.nu2u_spread(vals, co, nfine, per, w, 16.1)
	nufft_cuda.u2nu_points(fine, co.reshape(-1, 2), per, w, 16.1)
	assert [n for n, _ in calls] == ["tile_keys", "u2nu_points", "nu2u_spread", "u2nu_points"]
	assert len({args[4:7] for n, args in calls[1:]}) == 1
	assert nufft_cuda.LAUNCHES == {"tile_keys": 1, "u2nu_points": 2, "nu2u_spread": 1}
	nufft_cuda.clear_bins()


@pytest.mark.parametrize("name", ("u2nu_points", "nu2u_spread"))
def test_wrapper_launches_binned(name, monkeypatch):
	"""On the card the wrappers take K12's keys (tile_keys), bin the points
	on them and launch on the bins: the recorded arguments of both launches
	(the keys' format, pointers to the bins bin_points gives, their
	subproblem count, the tile, the component plan), each launch counted."""
	rng = np.random.default_rng(2)
	co = torch.from_numpy(rng.uniform(-1, 7, (500, 2)))
	nfine, w, beta = (40, 72), 7, 16.1
	calls = []

	def call(n, dev, *args):
		calls.append((n, args))
		if n == "tile_keys":   # the twin's keys into the wrapper's buffer (host memory here)
			want = nufft_core.tile_keys(co, nfine, PER, w, torch.float64, nufft_cuda.TILE)
			ctypes.memmove(args[3], want.data_ptr(), want.numel()*want.element_size())

	real_bins = nufft_core.bin_points
	made = []
	nufft_cuda.clear_bins()
	monkeypatch.setattr(nufft_cuda, "library", PlanLib)
	monkeypatch.setattr(nufft_core, "bin_points", lambda *a, **k: made.append(real_bins(*a, **k)) or made[-1])
	monkeypatch.setattr(nufft_cuda, "_on_card", lambda x: True)
	monkeypatch.setattr(nufft_cuda, "_stream", lambda x: 0)
	monkeypatch.setattr(nufft_cuda, "_call", call)
	nufft_cuda.reset_launches()
	x = torch.from_numpy(rng.standard_normal((3, 500) if name == "nu2u_spread" else (3,) + nfine))
	if name == "u2nu_points": nufft_cuda.u2nu_points(x, co, PER, w, beta)
	else: nufft_cuda.nu2u_spread(x, co, nfine, PER, w, beta)
	(nk, kargs), (n, args) = calls
	b, = made
	assert nk == "tile_keys" and n == name
	assert nufft_cuda.LAUNCHES == {k: int(k in (name, "tile_keys")) for k in nufft_cuda.KERNELS}
	assert nufft_cuda.LAUNCHES_BY_DTYPE[(name, "float64", "real")] == 1
	assert nufft_cuda.LAUNCHES_BY_DTYPE[("tile_keys", "float64", "int16")] == 1
	assert kargs[:3] == (1, 2, co.data_ptr()) and kargs[4:] == (500, nfine[0], nfine[1], PER[0], PER[1],
		w) + nufft_cuda.TILE + (32768, 0)
	assert args[:4] == (1, 0, x.data_ptr(), co.data_ptr())
	assert args[4:7] == (b.perm.data_ptr(), b.subs.data_ptr(), b.subs.shape[0])
	cc = nufft_cuda.components(name == "nu2u_spread", 3, 8, 1, w)
	assert cc == 3
	assert args[8:13] == (3, cc, nfine[0], nfine[1], 500)
	assert args[13:] == (PER[0], PER[1], w, beta) + nufft_cuda.TILE + (0,)
	want = real_bins(co, nfine, PER, w, torch.float64, nufft_cuda.TILE, nufft_cuda.CAP)
	assert torch.equal(want.perm, b.perm) and torch.equal(want.subs, b.subs)
	nufft_cuda.clear_bins()


def test_tile_keys_wrapper_checks():
	co = torch.zeros(5, 2, dtype=torch.float64)
	with pytest.raises(TypeError):
		nufft_cuda.tile_keys(co, (20, 20), PER, 7, torch.float16, (8, 8))
	with pytest.raises(ValueError):
		nufft_cuda.tile_keys(co.float(), (20, 20), PER, 7, torch.float64, (8, 8))
	with pytest.raises(ValueError):
		nufft_cuda.tile_keys(co, (20, 20), PER, 17, torch.float64, (8, 8))
	nufft_cuda.reset_launches()
	assert torch.equal(nufft_cuda.tile_keys(co, (20, 20), PER, 7, torch.float64, (8, 8)),
		nufft_core.tile_keys(co, (20, 20), PER, 7, torch.float64, (8, 8)))
	assert sum(nufft_cuda.LAUNCHES.values()) == 0
