"""The block-Legendre split of the port (pixell_tpu_torch: ops.sht_cuda's
host tables and dispatch, ops.sht_core's plain versions of the block kernels
and of K3/K4's state handoff, sht.blocked, enmap.slice_geometry) on the CPU
against pixell_tpu, whose Pallas kernels run in interpret mode as in its own
tests (tests/test_pallas.py test_blocked_legendre_split). The CUDA kernels
(csrc/blockleg.cu, and csrc/legendre.cu's stop degrees) run only on a GPU;
chip_smoke.py holds them against these plain versions there.

Tolerances, each of the largest reference value unless stated:
- tables: the start and stop tables equal the reference's entry for entry;
  the node values within 2 float32 ulp of 1 (2.4e-7); the Lagrange basis
  through the ideal nodes within 6e-5 of the reference's float32 W (2e-3 at
  a tile's edge rings: twice what its float32 build is off by), and the
  port's own W interpolates a degree-127 polynomial to 1e-11; the stream
  tables within one float32 ulp (XLA's CPU sqrt and divide are off by one
  ulp on a few entries), two for the products of three rounded factors.
- the plain block kernels against the reference's in interpret mode, same
  state and tables: 2e-5 (float32, another summation order in the node ->
  ring product).
- the state handed over, compared unscaled, and the prefix: 5e-5 (two
  float32 recurrences of 112 steps on rings from 0.2 rad, rounded apart).
- split against unsplit: 0 < difference < 3e-5 (scalar), 5e-5 (deriv,
  spin1), 2e-4 (spin2), the reference's own bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky, sht as jsht
from pixell_tpu.ops import sht_core as jcore, sht_pallas as jpallas
from pixell_tpu_torch import enmap, curvedsky, sht
from pixell_tpu_torch.ops import sht_cuda, sht_core

MODES = [("scalar", 2, 3e-5), ("deriv", 2, 5e-5), ("spin1", 2, 5e-5), ("spin2", 4, 2e-4)]
LB = sht_cuda.BLK_LB


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
	"""These tests run whole-array loops of a few hundred steps on small
	arrays: with one intra-op thread per core in each of several pytest-xdist
	workers they spend their time waiting for each other."""
	n = torch.get_num_threads()
	torch.set_num_threads(min(n, 2))
	yield
	torch.set_num_threads(n)


def relerr(x, ref):
	x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
	ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
	return float(np.abs(x.astype(np.complex128) - ref).max()/np.abs(ref).max())


def f1_rings(lmax):
	"""The reference test's ring set: Fejer-1 without its last three rings,
	so not south-symmetric."""
	return np.asarray(jsht.ring_theta("F1", 2*lmax + 2), np.float64)[:-3]


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lmax,tb", [(448, 256), (448, 1024), (2000, 256), (2000, 1024)])
def test_start_and_stop_tables_match_reference(lmax, tb):
	"""At the reference's tile sizes (128 m rows, tb rings) the start table
	equals _blk_start_table entry for entry, and with the dead table the
	stop degrees equal its lstop (sht_pallas.py:1191-1197, in 16-degree
	units there)."""
	nlb = -(-(lmax + 1)//LB)
	some = False
	for theta in (f1_rings(lmax), f1_rings(lmax)[:2048][40:], np.arange(1201)*np.pi/1200):
		ref = jpallas._blk_start_table(theta, lmax, lmax, tb)
		mine = sht_cuda.blk_start_table(theta, lmax, lmax, jpallas.MB, tb)
		assert mine.dtype == np.int32 and np.array_equal(mine, ref)
		some = some or bool((ref < nlb).any())
		dead = jpallas._dead_table(theta, lmax, lmax, tb)
		start, stop = sht_cuda.blk_split(mine, dead, lmax)
		ref_start = np.where(dead, nlb, ref)
		assert np.array_equal(start, ref_start)
		assert np.array_equal(stop, np.where(dead, 0, ref_start*(LB//jpallas.LB))*jpallas.LB)
	# at lmax 448 only the narrow tiles have an oscillatory block
	assert some or (lmax, tb) == (448, 1024), "no eligible tile in any ring set"
	assert (LB, sht_cuda.BLK_JP, sht_cuda.BLK_GMAX, sht_cuda.BLK_MINL, sht_cuda.BLK_ENABLE) == \
		(jpallas.BLK_LB, jpallas.BLK_JP, jpallas.BLK_GMAX, jpallas.BLK_MINL, jpallas.BLK_ENABLE)


def test_port_tiles():
	"""The tables at the port's own tiles: every K3/K4 block takes its block
	tile's stop degree, a multiple of 112 (hence of 8, where the state is
	just renormalized); tiles without a suffix skip their dead blocks as the
	unsplit path does; ring tiles near a pole are never eligible; the tables
	are cached per ring set."""
	lmax = 448
	theta = f1_rings(lmax)
	nm, nt = lmax + 1, len(theta)
	tab, lstop = sht_cuda.blk_tables(theta, lmax, lmax, "cpu")
	assert sht_cuda.blk_tables(theta, lmax, lmax, "cpu")[0] is tab
	nlb = -(-nm//LB)
	TM, TT = sht_cuda.BLK_TILE_M, sht_cuda.BLK_TILE_T
	assert (tab.tile_m, tab.tile_t) == (TM, TT) and TM % sht_cuda.TILE_M == 0 and TT % sht_cuda.TILE_T == 0
	assert tuple(tab.start.shape) == (-(-nm//TM), -(-nt//TT)) and tab.start.dtype == torch.int32
	assert tuple(lstop.shape) == (-(-nm//sht_cuda.TILE_M), -(-nt//sht_cuda.TILE_T))
	start = tab.start.numpy()
	assert 0 < (start < nlb).sum() < start.size and start.min() >= 1
	rt = TT//sht_cuda.TILE_T
	up = np.repeat(np.repeat(start, TM//sht_cuda.TILE_M, 0), rt, 1)[:lstop.shape[0], :lstop.shape[1]]
	ls = lstop.numpy()
	assert np.array_equal(ls[up < nlb], up[up < nlb]*LB) and (ls[up < nlb] % 8 == 0).all()
	dead = sht_cuda.dead_stops(theta, lmax, lmax, 0, "cpu").numpy()
	assert np.array_equal(ls[up >= nlb], dead[up >= nlb])
	# a block starts above its tile's largest m
	m_hi = np.minimum((np.arange(start.shape[0]) + 1)*TM, nm) - 1
	assert (start*LB > m_hi[:, None])[start < nlb].all()
	# the polar ring tiles: sin(theta) below BLK_SMIN at their most polar ring
	polar = sht_cuda.blk_polar_tiles(theta, TT)
	smin = np.array([np.sin(theta[i:i + TT]).min() for i in range(0, nt, TT)])
	assert np.array_equal(polar, smin < sht_cuda.BLK_SMIN) and polar.any() and not polar.all()
	assert (start[:, polar] == nlb).all()
	free = sht_cuda.blk_start_table(theta, lmax, lmax, TM, TT)
	assert (free[:, polar] < nlb).any() and np.array_equal(free[:, ~polar], start[:, ~polar])
	# no tile with a suffix: None
	assert sht_cuda.blk_tables(theta[:64], 100, 100, "cpu") is None
	assert not sht_cuda.blk_ok("scalar", torch.float32, 2000)             # off by default
	with sht.blocked():
		assert sht_cuda.blk_ok("spin2", torch.float32, 1024)
		assert not sht_cuda.blk_ok("scalar", torch.float32, 1023)
		assert not sht_cuda.blk_ok("scalar", torch.float64, 2000)
		assert not sht_cuda.blk_ok("wigner", torch.float32, 2000)


def test_node_tables():
	"""ctv against _blk_node_tables; the Lagrange basis through the ideal
	Chebyshev nodes against its W; and the port's own W, through the float32
	node values the kernels use: its columns sum to 1, it interpolates a
	polynomial of degree 127 sampled at those values, and padding rings get
	zeros."""
	tb, JP = 256, sht_cuda.BLK_JP
	theta = f1_rings(448)[100:100 + 2*tb]
	nt = len(theta)
	cth = jpallas._ct_parts(theta)[0]
	ctv_ref, W_ref = (np.asarray(x, np.float64) for x in jpallas._blk_node_tables(cth, nt, nt, tb))
	ctv, W = sht_cuda.blk_node_tables(theta, tb)
	assert ctv.shape == (2, JP) and W.shape == (2, JP, tb)
	assert np.array_equal(ctv, ctv.astype(np.float32))          # float32 numbers
	assert np.abs(ctv - ctv_ref[:, 0]).max() <= 2.4e-7
	ct32 = np.asarray(cth, np.float64).reshape(2, tb)
	xn = np.cos(np.pi*(np.arange(JP) + 0.5)/JP)
	# the reference's W comes from a float32 Chebyshev recurrence up to degree
	# 127: off by up to 2.6e-5, and 7.5e-4 at the tile's edge rings (x = +-1)
	for n in range(2):
		c0, h = (ct32[n].max() + ct32[n].min())/2, (ct32[n].max() - ct32[n].min())/2
		x = (ct32[n] - c0)/h
		diff = np.abs(sht_cuda.lagrange_basis(xn, x) - W_ref[n]).max(0)
		assert diff[np.abs(x) < 0.999].max() <= 6e-5 and diff.max() <= 2e-3
	assert np.abs(W.sum(1) - 1).max() <= 1e-12
	rng = np.random.default_rng(0)
	coef = rng.standard_normal(JP)
	ct = np.cos(theta).reshape(2, tb)
	for n in range(2):
		c0, h = (ct[n].max() + ct[n].min())/2, (ct[n].max() - ct[n].min())/2
		poly = lambda x: np.polynomial.chebyshev.chebval((x - c0)/h, coef)
		assert np.abs(poly(ctv[n]) @ W[n] - poly(ct[n])).max() <= 1e-11*np.abs(poly(ct[n])).max()
	# a ragged last tile, and a ring that sits on a node
	ctv3, W3 = sht_cuda.blk_node_tables(theta[:tb + 40], tb)
	assert W3.shape == (2, JP, tb) and (W3[1, :, 40:] == 0).all()
	assert np.abs(W3[1, :, :40].sum(0) - 1).max() <= 1e-12
	L = sht_cuda.lagrange_basis(xn, xn[[5, 77]])
	assert L[5, 0] == 1 and L[77, 1] == 1 and np.abs(L).sum() == 2


@pytest.mark.parametrize("mode", ["deriv", "spin1", "spin2"])
def test_stream_tables_match_reference(mode):
	nl, nm = 4097, 128
	ref = {"deriv": jpallas._deriv_stream_tables, "spin1": jpallas._spin1_stream_tables,
		"spin2": jpallas._spin2_stream_tables}[mode](nl, nm)
	mine = sht_core.blk_stream_tables(nl, nm, mode, torch.float32)
	assert mine.dtype == torch.float32 and tuple(mine.shape) == (len(sht_core.BLK_FAM[mode]), nl, nm)
	np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=2.4e-7, atol=0)
	# e_lm is the factored one of recur_e, exactly
	l = torch.arange(nl, dtype=torch.float32)[:, None]
	m = torch.arange(nm, dtype=torch.float32)[None, :]
	e = sht_core.recur_e(l, m)
	if mode == "deriv":
		assert torch.equal(mine[2], -e) and torch.equal(mine[1], l.expand(nl, nm))
		assert bool((mine[0] == 1).all())
		np.testing.assert_allclose(mine[2].numpy(), np.asarray(ref)[2], rtol=1.2e-7, atol=0)
	assert tuple(sht_core.blk_stream_tables(5, 3, "scalar", torch.float64).shape) == (1, 5, 3)
	with pytest.raises(ValueError):
		sht_core.blk_stream_tables(5, 3, "wigner", torch.float32)


# ---------------------------------------------------------------------------
# the plain block kernels against the reference's, in interpret mode
# ---------------------------------------------------------------------------
def blk_case(mode, C, seed):
	"""Three 112-degree blocks, 16 m rows, two ring tiles of 128 mid-latitude
	rings; the tiles start at blocks 1 and 2, so two blocks run; a random
	O(1) state at levels 0 and -1."""
	lmax, mmax, tb = 3*LB - 1, 15, 128
	theta = np.linspace(0.9, 2.2, 2*tb)
	rng = np.random.default_rng(seed)
	nfun = sht_core.NFUN[mode]
	A = rng.standard_normal((lmax + 1, mmax + 1, C)).astype(np.float32)
	F = rng.standard_normal((nfun, C, mmax + 1, 2*tb)).astype(np.float32)
	state = np.zeros((3, jpallas.MB, 2*tb), np.float32)
	state[:2] = rng.standard_normal((2, jpallas.MB, 2*tb))
	state[2] = -rng.integers(0, 2, (jpallas.MB, 2*tb))
	start = np.array([[1, 2]], np.int32)
	cth = jpallas._ct_parts(theta)[0]
	ctv, W = jpallas._blk_node_tables(cth, 2*tb, 2*tb, tb)
	th = jpallas._prep_th(theta, tb)
	tab = sht_core.BlkTables(torch.from_numpy(start), torch.from_numpy(np.asarray(ctv)[:, 0].copy()),
		torch.from_numpy(np.asarray(W).copy()), jpallas.MB, tb)
	g = sht_cuda.geom(theta, mmax, torch.float32, "cpu")
	return lmax, mmax, A, F, state, start, ctv, W, th, tab, g


@pytest.mark.parametrize("mode,C", [(m, c) for m, c, _ in MODES])
def test_blk_synthesis_matches_reference_kernel(mode, C):
	lmax, mmax, A, F, state, start, ctv, W, th, tab, g = blk_case(mode, C, 1)
	if mode == "scalar":
		ref = jpallas._synth_blk_call(A, lmax, mmax, jnp.asarray(state), jnp.asarray(start), ctv, W,
			interpret=True)
	else:
		ref = jpallas._synth_blk_call_streams(A, lmax, mmax, jnp.asarray(state), jnp.asarray(start),
			ctv, W, th, mode=mode, interpret=True)
	ref = np.asarray(ref)[:, :, :mmax + 1]
	st = torch.from_numpy(state[:, :mmax + 1].copy())
	got = sht_cuda.blk_synthesis(torch.from_numpy(A), st, tab, g, lmax, mode)
	assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
	assert np.abs(ref).max() > 1 and relerr(got, ref) < 2e-5
	# in float64, from the same float32 state: the float32 run's own error
	tab64 = sht_core.BlkTables(tab.start, tab.ctv.double(), tab.W.double(), tab.tile_m, tab.tile_t)
	g64 = sht_cuda.geom(np.linspace(0.9, 2.2, 256), mmax, torch.float64, "cpu")
	got64 = sht_core.blk_synthesis(torch.from_numpy(A).double(), st.double(), tab64, g64, lmax, mode)
	assert got64.dtype == torch.float64 and relerr(got, got64) < 2e-5
	assert sht_cuda.LAUNCHES["blk_synthesis"] == 0                     # no kernel on the CPU


@pytest.mark.parametrize("mode,C", [(m, c) for m, c, _ in MODES])
def test_blk_analysis_matches_reference_kernel(mode, C):
	lmax, mmax, A, F, state, start, ctv, W, th, tab, g = blk_case(mode, C, 2)
	if mode == "scalar":
		ref = jpallas._anal_blk_call(F, lmax, mmax, jnp.asarray(state), jnp.asarray(start), ctv, W,
			interpret=True)
	else:
		ref = jpallas._anal_blk_call_streams(F, lmax, mmax, jnp.asarray(state), jnp.asarray(start),
			ctv, W, th, mode=mode, interpret=True)
	ref = np.asarray(ref)
	st = torch.from_numpy(state[:, :mmax + 1].copy())
	got = sht_cuda.blk_analysis(torch.from_numpy(F), st, tab, g, lmax, mode)
	assert tuple(got.shape) == ref.shape == (lmax + 1, mmax + 1, C)
	assert bool((got[:LB] == 0).all()) and not np.asarray(ref[:LB]).any()   # below every first block
	assert np.abs(ref).max() > 1 and relerr(got, ref) < 2e-5
	assert sht_cuda.LAUNCHES["blk_analysis"] == 0


def test_blk_wrapper_checks():
	lmax, mmax, A, F, state, start, ctv, W, th, tab, g = blk_case("scalar", 2, 3)
	st = torch.from_numpy(state[:, :mmax + 1].copy())
	with pytest.raises(ValueError):   # a state of another grid
		sht_cuda.blk_synthesis(torch.from_numpy(A), st[:, :-1], tab, g, lmax)
	with pytest.raises(ValueError):   # no block path in the wigner mode
		sht_core.blk_synthesis(torch.from_numpy(A), st, tab, g, lmax, "wigner")
	with pytest.raises(ValueError):
		sht_cuda.blk_analysis(torch.zeros((2, 2, mmax + 1, 256)), st, tab, g, lmax, "scalar")
	with pytest.raises(RuntimeError, match="no Legendre kernel"):
		sht_cuda.blk_synthesis(torch.zeros((lmax + 1, mmax + 1, 2), device="meta"), st, tab,
			sht_cuda.geom(np.linspace(0.9, 2.2, 256), mmax, torch.float32, "meta"), lmax)
	# the handoff is a float32 Legendre-mode launch with stop degrees
	lstop = torch.full((-(-(mmax + 1)//sht_cuda.TILE_M), 4), LB, dtype=torch.int32)
	with pytest.raises(ValueError):
		sht_cuda._mode_args(g, lmax + 1, "scalar", None, torch.device("cpu"), True)
	g64 = sht_cuda.geom(np.linspace(0.9, 2.2, 256), mmax, torch.float64, "cpu")
	with pytest.raises(ValueError):
		sht_cuda._mode_args(g64, lmax + 1, "scalar", lstop, torch.device("cpu"), True)
	with pytest.raises(ValueError):
		sht_core.synthesis(torch.from_numpy(A), g, lmax, dump_state=True)
	gw = sht_cuda.geom(np.linspace(0.9, 2.2, 256), mmax, torch.float32, "cpu", 3)
	with pytest.raises(ValueError):
		sht_core.synthesis(torch.from_numpy(A), gw, lmax, "wigner",
			sht_cuda.stop_entries(lstop, mmax + 1, 256), True)


# ---------------------------------------------------------------------------
# the handoff
# ---------------------------------------------------------------------------
def unscaled(state, S=60):
	state = np.asarray(state, np.float64)
	return state[:2]*np.exp2(S*state[2])


@pytest.mark.parametrize("mode,C", [("scalar", 2), ("spin2", 4)])
def test_state_handoff_matches_reference(mode, C):
	"""K3's and K4's plain versions stopped at degree 112: the prefix and
	the state handed over, against _synthesis_scan_pallas_full and
	_analysis_scan_pallas_full with dump_state in interpret mode. m up to 70
	on rings from 0.2 rad puts levels 0, -1 and -2 into the state."""
	lmax, mmax, nt = 2*LB - 1, 70, 200
	theta = np.linspace(0.2, 2.0, nt)
	rng = np.random.default_rng(4)
	nfun = sht_core.NFUN[mode]
	A = rng.standard_normal((lmax + 1, mmax + 1, C)).astype(np.float32)
	F = rng.standard_normal((nfun, C, mmax + 1, nt)).astype(np.float32)
	cth, ctl = jpallas._ct_parts(theta)
	assert jpallas._pick_tb(nfun, C, nt=nt) >= nt            # one reference tile
	ref_stop = jnp.asarray([[LB//jpallas.LB]], jnp.int32)
	G_ref, s_ref = jpallas._synthesis_scan_pallas_full(A, theta, lmax, mmax, mode=mode,
		interpret=True, cth=cth, ctl=ctl, lstop=ref_stop, dump_state=True)
	a_ref, sa_ref = jpallas._analysis_scan_pallas_full(F, theta, lmax, mmax, mode=mode,
		interpret=True, cth=cth, ctl=ctl, lstop=ref_stop, dump_state=True)
	g = sht_cuda.geom(theta, mmax, torch.float32, "cpu")
	lstop = torch.full((-(-(mmax + 1)//sht_cuda.TILE_M), -(-nt//sht_cuda.TILE_T)), LB,
		dtype=torch.int32)
	G, state = sht_cuda.full_synthesis(torch.from_numpy(A), g, lmax, mode, lstop, True)
	a, state_a = sht_cuda.full_analysis(torch.from_numpy(F), g, lmax, mode, lstop, True)
	assert tuple(state.shape) == (3, mmax + 1, nt) and state.dtype == torch.float32
	assert torch.equal(state, state_a)                        # one recurrence
	s_ref = np.asarray(s_ref)[:, :mmax + 1, :nt]
	assert np.array_equal(np.asarray(sa_ref)[:, :mmax + 1, :nt], s_ref)
	levels = set(np.unique(state[2].numpy()).tolist())
	assert {0.0, -1.0} <= levels and np.array_equal(state[2].numpy(), s_ref[2])
	assert relerr(unscaled(state), unscaled(s_ref)) < 5e-5
	assert relerr(G, np.asarray(G_ref)[:, :, :mmax + 1, :nt]) < 5e-5
	assert relerr(a, np.asarray(a_ref)) < 5e-5
	assert not a[LB:].any() and a[:LB].abs().max() > 0         # no degree from the stop on
	# the stop is where the full run stood after degree 111
	full = [s for s in sht_core.lambdas(g, LB - 1)]
	G_full = sht_cuda.full_synthesis(torch.from_numpy(A[:LB]), g, LB - 1, mode)
	assert torch.equal(G, G_full) and len(full) == LB
	# stops past lmax hand the final state over; 0 hands zeros
	for fill, check in ((lmax + 1, lambda s: bool(s[:2].abs().max() > 0)), (0, lambda s: not s.any())):
		_, st = sht_cuda.full_synthesis(torch.from_numpy(A), g, lmax, mode, torch.full_like(lstop, fill), True)
		assert check(st)


# ---------------------------------------------------------------------------
# split against unsplit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,C,tol", MODES)
def test_split_against_unsplit(mode, C, tol, monkeypatch):
	"""The port's dispatch with the split and without, on the CPU, on the
	reference test's kind of ring set (lmax 335 on 669 Fejer-1 rings: three
	112-degree blocks, one ring tile clear of the poles) and within its
	bounds; entries of tiles without a suffix bit-identical; and against
	pixell_tpu.ops.sht_core in float64 the split is as close as the stepwise
	float32 scan is (within 5 % and 1e-5 of the largest value)."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	lmax = 335
	theta = f1_rings(lmax)
	nt, nfun, f32 = len(theta), sht_core.NFUN[mode], torch.float32
	assert sht_cuda.detect_sym(theta) is None
	rng = np.random.default_rng(0)
	A = np.zeros((lmax + 1, lmax + 1, C), np.float32)
	mask = np.tril(np.ones((lmax + 1, lmax + 1), bool))
	A[mask] = rng.standard_normal((int(mask.sum()), C)).astype(np.float32)
	F = rng.standard_normal((nfun, C, lmax + 1, nt)).astype(np.float32)
	tA, tF = torch.from_numpy(A), torch.from_numpy(F)
	with sht.blocked():
		G_blk = sht_cuda._synth_rings(tA, theta, lmax, lmax, mode, f32)
		O_blk = sht_cuda._anal_rings(tF, theta, lmax, lmax, mode, f32)
	assert not sht_cuda.BLK_ENABLE
	G_stp = sht_cuda._synth_rings(tA, theta, lmax, lmax, mode, f32)
	O_stp = sht_cuda._anal_rings(tF, theta, lmax, lmax, mode, f32)
	es, ea = relerr(G_blk, G_stp), relerr(O_blk, O_stp)
	assert 0 < es < tol, es
	assert 0 < ea < tol, ea
	tab, lstop = sht_cuda.blk_tables(theta, lmax, lmax, "cpu")
	stop = sht_cuda.stop_entries(lstop, lmax + 1, nt)
	unsplit = (stop == 0) | (stop > lmax)
	assert 0 < int(unsplit.sum()) < unsplit.numel()
	assert torch.equal(G_blk[..., unsplit], G_stp[..., unsplit])
	first = int(tab.start.min())*LB
	assert torch.equal(O_blk[:first], O_stp[:first])
	# the reference's float64 scan, on every eighth ring (a ring's values are its own)
	G64 = np.asarray(jcore.synthesis_scan(jnp.asarray(A, jnp.float64), theta[::8], lmax, lmax,
		mode=mode, dtype=np.float64))
	assert relerr(G_blk[..., ::8], G64) <= 1.05*relerr(G_stp[..., ::8], G64) + 1e-5
	O64 = np.asarray(jcore.analysis_scan(jnp.asarray(F, jnp.float64), theta, lmax, lmax,
		mode=mode, dtype=np.float64))
	assert relerr(O_blk, O64) <= 1.05*relerr(O_stp, O64) + 1e-5


def test_no_suffix_falls_back(monkeypatch):
	"""Where no tile has a blocked suffix the split is plain K3/K4 with the
	dead-tile stops, bit for bit."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 16)
	lmax = 100
	theta = f1_rings(lmax)
	assert sht_cuda.blk_tables(theta, lmax, lmax, "cpu") is None
	rng = np.random.default_rng(1)
	A = torch.from_numpy(rng.standard_normal((lmax + 1, lmax + 1, 2))).float()
	F = torch.from_numpy(rng.standard_normal((1, 2, lmax + 1, len(theta)))).float()
	with sht.blocked():
		G, O = (sht_cuda._synth_rings(A, theta, lmax, lmax, "scalar", torch.float32),
			sht_cuda._anal_rings(F, theta, lmax, lmax, "scalar", torch.float32))
	assert torch.equal(G, sht_cuda._synth_rings(A, theta, lmax, lmax, "scalar", torch.float32))
	assert torch.equal(O, sht_cuda._anal_rings(F, theta, lmax, lmax, "scalar", torch.float32))


# ---------------------------------------------------------------------------
# the band geometry and the switch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sel", [(slice(36, 151), slice(None)), (slice(10, 170, 3), slice(5, 300, 2)),
	slice(20, 40), (slice(None, None, -1), slice(350, 10, -4)), (slice(-30, None), slice(None, -7))],
	ids=["band", "steps", "y-only", "negative-steps", "negative-bounds"])
def test_slice_geometry_matches_reference(sel):
	shape, wcs = enmap.fullsky_geometry(shape=(180, 360), variant="fejer1")
	jshape, jwcs = jenmap.fullsky_geometry(shape=(180, 360), variant="fejer1")
	for pre in ((), (3,)):
		for nowrap in (False, True):
			if nowrap and sel is not None and any(s.start is not None and s.start < 0
					for s in (sel if isinstance(sel, tuple) else (sel,))): continue
			got = enmap.slice_geometry(pre + shape, wcs, sel, nowrap=nowrap)
			ref = jenmap.slice_geometry(pre + jshape, jwcs, sel, nowrap=nowrap)
			assert got[0] == tuple(ref[0])
			for f in ("crpix", "cdelt", "crval"):
				np.testing.assert_allclose(getattr(got[1].wcs, f), getattr(ref[1].wcs, f), rtol=0, atol=1e-12)
			assert list(got[1].wcs.ctype) == list(ref[1].wcs.ctype)
	assert wcs == enmap.fullsky_geometry(shape=(180, 360), variant="fejer1")[1]   # the input is untouched
	with pytest.raises(ValueError):
		enmap.slice_geometry(shape, wcs, (None, slice(None)))
	# the pixels of the slice lie where the parent's do
	sel2 = sel if isinstance(sel, tuple) else (sel, slice(None))
	dec, ra = enmap.posaxes(shape, wcs)
	sdec, sra = enmap.posaxes(*enmap.slice_geometry(shape, wcs, sel))
	np.testing.assert_allclose(sdec, dec[sel2[0]], atol=1e-12)
	np.testing.assert_allclose(np.cos(sra), np.cos(ra[sel2[1]]), atol=1e-12)


def test_blocked_switch_restores():
	assert sht_cuda.BLK_ENABLE is False
	with sht.blocked():
		assert sht_cuda.BLK_ENABLE is True
		with sht.blocked(False):
			assert sht_cuda.BLK_ENABLE is False
		assert sht_cuda.BLK_ENABLE is True
	assert sht_cuda.BLK_ENABLE is False
	with pytest.raises(KeyError):
		with sht.blocked():
			raise KeyError("inside")
	assert sht_cuda.BLK_ENABLE is False


@pytest.mark.parametrize("spin,ncomp", [([0], 1), ([0, 2], 3)], ids=["spin0", "IQU"])
def test_curvedsky_band_under_blocked(spin, ncomp, monkeypatch):
	"""alm2map onto a declination band (not south-symmetric, so K3 and the
	block kernel) and, for spin 0, map2alm of the full sky (the half-sky
	kernels switched off, so K4 and the block kernel) under sht.blocked(), with BLK_MINL
	lowered to a CPU size, against pixell_tpu's curvedsky in float64: 5e-4,
	the float32 transform's bound at this size, and the alm roundtrip within
	the same. The engine's entry points are sent to the kernel dispatch, as
	on the card (on CPU tensors they run the plain scan, which has no
	split), where the kernels' plain versions run."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	monkeypatch.setattr(sht_cuda, "SYM_MAX_NH", 64)
	monkeypatch.setattr(sht_cuda, "synthesis_scan", sht_cuda.kernel_synthesis)
	monkeypatch.setattr(sht_cuda, "analysis_scan", sht_cuda.kernel_analysis)
	lmax = 448   # 900 rings after the upsample: one ring tile of 256 wholly at sin(theta) >= BLK_SMIN
	shape, wcs = enmap.fullsky_geometry(shape=(450, 900), variant="fejer1")
	jshape, jwcs = jenmap.fullsky_geometry(shape=(450, 900), variant="fejer1")
	sel = (slice(80, 360), slice(None))   # declinations -54 .. +58 degrees: sin(theta) >= BLK_SMIN
	bshape, bwcs = enmap.slice_geometry(shape, wcs, sel)
	jbshape, jbwcs = jenmap.slice_geometry(jshape, jwcs, sel)
	minfo = curvedsky.analyse_geometry(bshape, bwcs)
	assert minfo.case == "2d" and minfo.ypad == (90, 80) and sht_cuda.detect_sym(minfo.theta) is None
	calls = []
	for name in sht_cuda.BLK_KERNELS:
		def spy(*a, _f=getattr(sht_cuda, name), _n=name):
			calls.append((_n, a[-1]))
			return _f(*a)
		monkeypatch.setattr(sht_cuda, name, spy)
	rng = np.random.default_rng(9)
	n = sht.nalm(lmax)
	alm = rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n))
	alm[:, :lmax + 1] = alm[:, :lmax + 1].real
	l = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
	for i, s in enumerate(curvedsky._comp_spins(spin, ncomp)): alm[i, l < s] = 0
	talm = torch.from_numpy(alm).to(torch.complex64)
	if ncomp == 1: talm, alm = talm[0], alm[0]
	pre = () if ncomp == 1 else (ncomp,)
	f32 = torch.float32
	with sht.blocked():
		band = curvedsky.alm2map(talm, enmap.zeros(pre + bshape, bwcs, f32, device="cpu"), spin=spin)
	modes = ["scalar"] + (["spin2"] if ncomp == 3 else [])
	assert calls == [("blk_synthesis", md) for md in modes]
	ref = jcurvedsky.alm2map(alm, jenmap.zeros(pre + jbshape, jbwcs, np.float64), spin=spin)
	assert band.data.dtype == f32 and relerr(band.data, ref) < 5e-4
	plain = curvedsky.alm2map(talm, enmap.zeros(pre + bshape, bwcs, f32, device="cpu"), spin=spin)
	assert len(calls) == len(modes) and 0 < relerr(band.data, plain.data) < 2e-4
	if ncomp > 1: return
	# the full sky back to alm
	full = curvedsky.alm2map(talm, enmap.zeros(pre + shape, wcs, f32, device="cpu"), spin=spin)
	calls.clear()
	with sht.blocked():
		back = curvedsky.map2alm(full, lmax=lmax, spin=spin)
	assert calls == [("blk_analysis", md) for md in modes]
	aref = jcurvedsky.map2alm(jenmap.ndmap(jnp.asarray(full.data.numpy().astype(np.float64)), jwcs),
		lmax=lmax, spin=spin)
	assert relerr(back, aref) < 5e-4 and relerr(back, alm) < 5e-4
