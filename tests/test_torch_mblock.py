"""The m block of K1-K4 (csrc/legendre.cu with its mfirst argument) and
sht.synthesis_rect / analysis_rect on the CPU.

- The tables of an m block m0 .. mmax are the whole transform's columns:
  the seeds (running products from m = 0, computed there and sliced) and
  the coefficient tables bit for bit; the dead-tile table of a block that
  does not start on a TILE_M boundary marks a tile dead only where the
  block's true m in it all lie beyond the horizon, and every tile the
  whole table marks dead that lies within the block's rows is dead there too.
- The plain twins on a block (the dispatch kernel_synthesis /
  kernel_analysis, which on CPU tensors runs the kernels' plain versions,
  and full_synthesis / full_analysis / sym_synthesis / sym_analysis with
  the block's stop degrees) against the same columns of the whole
  transform, in every mode, float32 and float64, with and without dead
  tiles: bit for bit where no stop table is taken, and within 1e-12 of the
  largest value where the two stop tables skip different tiles (each skips
  only terms below ~1e-12 of the peak).
- The card path's launch arguments, with _on_card, _stream and _launch
  monkeypatched so that the launches are recorded: every launch of K1-K4
  and of the near-pole passes on a block takes its first m as its last
  argument, the block's own tables (coefficients, seeds, stop degrees) and
  the near-pole pass only the block's columns below its m-extent; the
  block-Legendre split (sht.blocked()) on an m block raises
  NotImplementedError.
- synthesis_rect / analysis_rect against pixell_tpu.sht's in spin 0, IQU
  and spin [0, 3] (1e-12 / 1e-11, tests/test_parallel.py's bounds), and
  on m blocks against the whole rect's columns (1e-12);
  adjoint_synthesis_phase(rect_out=True, m_degeneracy=False) on an m
  block too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import sht as jsht
from pixell_tpu_torch import sht
from pixell_tpu_torch.ops import sht_cuda, sht_core

MODES = ["scalar", "deriv", "spin1", "spin2", "wigner"]
S = 3
LMAX = 40
BLOCKS = [(5, 23), (13, 41), (0, 9), (38, 41)]   # [m0, m1): starts on and off the m tile


def spin_of(mode):
	return S if mode == "wigner" else None


def ncol(mode):
	return 4 if mode in ("spin2", "wigner") else 2


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/np.abs(want).max()


def rings(kind):
	if kind == "sym": return (np.arange(48) + 0.5)*np.pi/48
	return np.sort(np.random.default_rng(0).uniform(0.01, np.pi - 0.01, 150))


def alm_cols(C, seed=1):
	A = torch.from_numpy(np.random.default_rng(seed).standard_normal((LMAX + 1, LMAX + 1, C)))
	return A*(torch.arange(LMAX + 1)[:, None, None] >= torch.arange(LMAX + 1)[None, :, None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [None, S])
def test_block_tables(dtype, s):
	theta = rings("full")
	whole = sht_cuda.geom(theta, LMAX, dtype, "cpu", s)
	for m0, m1 in BLOCKS:
		g = sht_cuda.geom(theta, m1 - 1, dtype, "cpu", s, m0)
		assert g.m0 == m0 and g.nm == m1 - m0
		assert torch.equal(g.seed_val, whole.seed_val[..., m0:m1, :])
		assert torch.equal(g.seed_level, whole.seed_level[..., m0:m1, :])
		tab = sht_cuda._coef_cached(LMAX + 1, m1 - m0, dtype, torch.device("cpu"), s, m0)
		want = sht_cuda._coef_cached(LMAX + 1, LMAX + 1, dtype, torch.device("cpu"), s)[..., m0:m1]
		assert torch.equal(tab, want)


@pytest.mark.parametrize("s", [0, S])
def test_block_dead_table(s):
	"""Polar rings at lmax 40 (sin theta < 0.07): the m tiles above ~m 34 are dead."""
	theta = np.linspace(0.002, 0.07, 130)
	whole = sht_cuda.dead_table(theta, LMAX, LMAX, sht_cuda.TILE_M, sht_cuda.TILE_T, s)
	assert whole.any()
	slack = 1.6*np.sqrt(LMAX) + 20
	smax = np.array([np.sin(theta[i:i + sht_cuda.TILE_T]).max() for i in range(0, 130, sht_cuda.TILE_T)])
	for m0 in (0, 5, 22, 33):
		blk = sht_cuda.dead_table(theta, LMAX, LMAX, sht_cuda.TILE_M, sht_cuda.TILE_T, s, m0)
		assert blk.shape == (-(-(LMAX + 1 - m0)//sht_cuda.TILE_M), whole.shape[1])
		for i in range(blk.shape[0]):
			ms = np.arange(m0 + i*sht_cuda.TILE_M, min(m0 + (i + 1)*sht_cuda.TILE_M, LMAX + 1))
			truly = (ms.min() - s) > LMAX*smax + slack
			np.testing.assert_array_equal(blk[i], truly)
			# a block tile whose m all lie in tiles the whole table marks dead is dead
			in_dead = np.all([whole[m//sht_cuda.TILE_M] for m in ms], 0)
			assert not (in_dead & ~blk[i]).any()
		stops = sht_cuda.dead_stops(theta, LMAX, LMAX, s, "cpu", m0)
		assert stops is None or torch.equal(stops == 0, torch.from_numpy(blk))


@pytest.mark.parametrize("kind", ["full", "sym"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
def test_dispatch_on_blocks(mode, dtype, kind):
	"""kernel_synthesis / kernel_analysis on m blocks against the whole
	transform's columns: each column's recurrence is its own, so bit for bit."""
	s, C, nf = spin_of(mode), ncol(mode), sht_core.NFUN[mode]
	theta = rings(kind)
	A = alm_cols(C)
	F = torch.from_numpy(np.random.default_rng(2).standard_normal((nf, C, LMAX + 1, len(theta))))
	G = sht_cuda.kernel_synthesis(A, theta, LMAX, LMAX, mode, dtype, s)
	R = sht_cuda.kernel_analysis(F, theta, LMAX, LMAX, mode, dtype, s)
	for m0, m1 in BLOCKS:
		g = sht_cuda.kernel_synthesis(A[:, m0:m1], theta, LMAX, m1 - 1, mode, dtype, s, m0=m0)
		r = sht_cuda.kernel_analysis(F[:, :, m0:m1], theta, LMAX, m1 - 1, mode, dtype, s, m0=m0)
		assert torch.equal(g, G[:, :, m0:m1]), (m0, m1)
		assert torch.equal(r, R[:, m0:m1]), (m0, m1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_wrappers_with_dead_tiles(mode, dtype):
	"""full_synthesis / full_analysis (and the half-sky forms in the Legendre
	modes) with each one's own dead-tile stops: the block's against the whole
	transform's columns within 1e-12 of the largest value; without stops bit
	for bit."""
	s, C, nf = spin_of(mode), ncol(mode), sht_core.NFUN[mode]
	theta = np.linspace(0.002, 0.07, 130)
	A = alm_cols(C)
	F = torch.from_numpy(np.random.default_rng(3).standard_normal((nf, C, LMAX + 1, len(theta))))
	gw = sht_cuda.geom(theta, LMAX, dtype, "cpu", s)
	sw = sht_cuda.dead_stops(theta, LMAX, LMAX, s or 0, "cpu")
	assert sw is not None
	stops = (lambda st: st) if dtype == torch.float32 else (lambda st: None)
	G = sht_cuda.full_synthesis(A.to(dtype), gw, LMAX, mode, stops(sw))
	R = sht_cuda.full_analysis(F.to(dtype), gw, LMAX, mode, stops(sw))
	for m0, m1 in BLOCKS:
		g = sht_cuda.geom(theta, m1 - 1, dtype, "cpu", s, m0)
		sb = sht_cuda.dead_stops(theta, LMAX, m1 - 1, s or 0, "cpu", m0)
		tol = 1e-12 if dtype == torch.float32 else 0
		got = sht_cuda.full_synthesis(A[:, m0:m1].to(dtype).contiguous(), g, LMAX, mode, stops(sb))
		assert float((got - G[:, :, m0:m1]).abs().max()) <= tol*float(G.abs().max())
		got = sht_cuda.full_analysis(F[:, :, m0:m1].to(dtype).contiguous(), g, LMAX, mode, stops(sb))
		assert float((got - R[:, m0:m1]).abs().max()) <= tol*float(R.abs().max())
	if mode == "wigner": return
	north = rings("sym")[:24]
	gs = sht_cuda.geom(north, LMAX, dtype, "cpu")
	EO = torch.from_numpy(np.random.default_rng(4).standard_normal((nf, C, 2, LMAX + 1, 24))).to(dtype)
	P, Q = sht_cuda.sym_synthesis(A.to(dtype), gs, LMAX, mode), sht_cuda.sym_analysis(EO, gs, LMAX, mode)
	for m0, m1 in BLOCKS:
		g = sht_cuda.geom(north, m1 - 1, dtype, "cpu", m0=m0)
		assert torch.equal(sht_cuda.sym_synthesis(A[:, m0:m1].to(dtype).contiguous(), g, LMAX, mode),
			P[..., m0:m1, :])
		assert torch.equal(sht_cuda.sym_analysis(EO[..., m0:m1, :].contiguous(), g, LMAX, mode), Q[:, m0:m1])


@pytest.fixture
def launches(monkeypatch):
	"""Record every kernel launch as (entry, mode, f64, arguments) instead of
	running it: CPU tensors take the card's path."""
	calls = []
	monkeypatch.setattr(sht_cuda, "_on_card", lambda x: True)
	monkeypatch.setattr(sht_cuda, "_stream", lambda x: 0)
	monkeypatch.setattr(sht_cuda, "_launch",
		lambda name, mode, device, f64, *args: calls.append((name, mode, f64, args)))
	return calls


@pytest.mark.parametrize("mode", MODES)
def test_block_launch_arguments(mode, launches):
	"""lmax 300 on 600 rings: K3 / K4 on the bulk in float32 with the block's
	stop degrees, the near-pole passes on the block's columns below their
	m-extent, K1 / K2 on a symmetric ring set; every launch's last argument
	is the block's first m and its tables are the block's."""
	lmax, s, C = 300, spin_of(mode), ncol(mode)
	nf = sht_core.NFUN[mode]
	theta = np.sort(np.random.default_rng(5).uniform(0.001, np.pi - 0.001, 600))
	cpu = torch.device("cpu")
	for m0, m1 in ((0, 77), (77, 154), (130, 301)):
		nb = m1 - m0
		A = torch.zeros((lmax + 1, nb, C))
		F = torch.zeros((nf, C, nb, len(theta)))
		for fn, x in ((sht_cuda.kernel_synthesis, A), (sht_cuda.kernel_analysis, F)):
			launches.clear()
			fn(x, theta, lmax, m1 - 1, mode, torch.float32, s, m0=m0)
			bulk = [c for c in launches if not c[0].startswith("polar")]
			polar = [c for c in launches if c[0].startswith("polar")]
			assert bulk and all(c[3][-1] == m0 for c in launches)
			# synthesis runs every ring (the near-pole ones overwritten after), analysis the bulk rings
			nn, ns = (0, 0) if x is A else sht_cuda.polar_counts(theta, lmax)
			g = sht_cuda.geom(theta[nn:len(theta) - ns], m1 - 1, torch.float32, cpu, s, m0)
			ab = sht_cuda._coef_cached(lmax + 1, nb, torch.float32, cpu, s, m0)
			for c in bulk:
				assert c[0] == sht_cuda.BULK_KERNELS["full_" + fn.__name__.split("_")[1]]
				assert c[3][2] == ab.data_ptr() and c[3][11] == nb and c[3][7] == g.seed_val.data_ptr()
			mp = max(min(m1, sht_cuda.POLAR_MMAX if s is None else max(sht_cuda.POLAR_MMAX, s + 1)) - m0, 0)
			assert bool(polar) == (mp > 0)
			for c in polar:
				assert c[3][-1] == m0 and (c[3][11] if "analysis" in c[0] else c[3][12]) == mp
		# float64: no near-pole pass, every launch the block's
		launches.clear()
		sht_cuda.kernel_synthesis(A.double(), theta, lmax, m1 - 1, mode, torch.float64, s, m0=m0)
		assert launches and all(c[2] and c[3][-1] == m0 for c in launches)
	if mode == "wigner": return
	launches.clear()
	sym = (np.arange(400) + 0.5)*np.pi/400
	sht_cuda.kernel_synthesis(torch.zeros((lmax + 1, 50, C)), sym, lmax, 89, mode, torch.float32, m0=40)
	assert sht_cuda.BULK_KERNELS["sym_synthesis"] in [c[0] for c in launches]
	assert all(c[3][-1] == 40 for c in launches)


def test_blocked_on_a_block_raises():
	with sht.blocked():
		old = sht_cuda.BLK_MINL
		sht_cuda.BLK_MINL = 16
		try:
			with pytest.raises(NotImplementedError):
				sht_cuda.kernel_synthesis(torch.zeros((41, 10, 2)), rings("full"), 40, 19, "scalar", m0=10)
		finally:
			sht_cuda.BLK_MINL = old
	g = sht_cuda.geom(rings("full"), 19, torch.float32, "cpu", m0=10)
	with pytest.raises(NotImplementedError):
		sht_core.blk_synthesis(torch.zeros((41, 10, 2)), torch.zeros((3, 10, 150)),
			sht_core.BlkTables(torch.zeros((3, 1), dtype=torch.int32), None, torch.zeros((1, 128, 256)), 4, 256),
			g, 40, "scalar")


NT, NPHI = 2*LMAX + 2, 2*LMAX + 4


@pytest.mark.parametrize("spin,ncomp", [((0,), 1), ((0, 2), 3), ((0, S), 3)])
def test_rect_transforms(spin, ncomp):
	theta, w = sht.ring_theta("F1", NT), sht.ring_weights("F1", NT)
	maps = np.random.default_rng(6).standard_normal((ncomp, NT, NPHI))
	jrect = np.array(jsht.analysis_rect(jnp.asarray(maps), jnp.asarray(theta), LMAX, jnp.asarray(w), spin=spin))
	rect = sht.analysis_rect(torch.from_numpy(maps), theta, LMAX, w, spin=spin)
	assert rel(rect, jrect) <= 1e-11
	jm = np.array(jsht.synthesis_rect(jnp.asarray(jrect), jnp.asarray(theta), NPHI, spin=spin))
	m = sht.synthesis_rect(torch.from_numpy(jrect), theta, NPHI, spin=spin)
	assert rel(m, jm) <= 1e-12
	for m0, m1 in ((7, 23), (23, LMAX + 1)):
		blk = sht.analysis_rect(torch.from_numpy(maps), theta, LMAX, w, mmax=m1 - 1, spin=spin, m0=m0)
		assert rel(blk, rect[..., m0:m1].numpy()) <= 1e-12
		part = sht.synthesis_rect(rect[..., m0:m1], theta, NPHI, lmax=LMAX, spin=spin, m0=m0)
		z = rect.clone()
		z[..., :m0] = 0
		z[..., m1:] = 0
		assert rel(part, sht.synthesis_rect(z, theta, NPHI, spin=spin).numpy()) <= 1e-12
		F = sht.ring_analysis(torch.from_numpy(maps), 0.0, LMAX + 1)
		whole = sht.adjoint_synthesis_phase(F, theta, LMAX, spin=spin, rect_out=True, m_degeneracy=False)
		got = sht.adjoint_synthesis_phase(F[..., m0:m1, :], theta, LMAX, mmax=m1 - 1, spin=spin, rect_out=True,
			m_degeneracy=False, m0=m0)
		assert rel(got, whole[..., m0:m1].numpy()) <= 1e-12
	with pytest.raises(ValueError):
		sht.adjoint_synthesis_phase(F[..., 5:, :], theta, LMAX, spin=spin, m0=5)
