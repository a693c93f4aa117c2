"""The general-spin (spin > 2) path of the port on the CPU: the Wigner-d
twin (pixell_tpu_torch.ops.sht_core), its tables, dispatch and dead-tile
table (ops.sht_cuda), and the transforms above them (sht, curvedsky), each
against pixell_tpu on the same inputs, made from a seed with numpy.

Tolerances, relative to the largest reference value unless stated:
- seeds: 1e-13 (float64) and 1.2e-7 (float32, one rounding of the float64
  value) per entry, on the true value val * 2^(S level), for every entry
  above 2^-900 (below ~2^-960 the reference's three-factor product
  underflows to 0; the port's does not); the float32 seeds are held against
  the float64 reference, since the reference's own float32 seeds round
  sin(theta/2) before raising it to the power m + s.
- coefficient tables: float64 1e-14 against the float64 formula; float32
  within three ulp of the reference's float32 tables (sqrt, multiply,
  divide and reciprocal each round there; the port rounds float64 once).
- float64 scans: 1e-11 (same recurrence, other summation order);
  float32 at lmax 200: 2e-4, the bound of tests/test_pallas.py for the
  plain float32 recurrence with its near-pole amplification.
- transforms: 1e-10 (float64), 5e-4 (float32 alm roundtrip).
- the dead-tile skip: 1e-9 (scalar), 1e-7 (spin2 and wigner) of the largest
  value, the bounds of tests/test_pallas.py test_dead_tile_skip.
The CUDA kernel (K7, csrc/legendre.cu in wigner mode) runs only on a GPU;
chip_smoke.py holds it against the twin tested here.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import sht as jsht, curvedsky as jcurvedsky, enmap as jenmap
from pixell_tpu.ops import sht_core as jcore, sht_pallas as jpallas
from pixell_tpu_torch import sht, curvedsky, enmap
from pixell_tpu_torch.ops import sht_core, sht_cuda


def relerr(x, ref):
	x, ref = np.asarray(x), np.asarray(ref)
	return np.abs(x - ref).max()/np.abs(ref).max()


GRIDS = {"F1": (np.arange(52) + 0.5)*np.pi/52, "CC": np.arange(51)*np.pi/50}


# ---------------------------------------------------------------------------
# seeds and tables
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def reference_seeds(grid, mmax, s):
	rv, rl = jcore._wigner_seeds(GRIDS[grid], mmax, s, np.float64)
	return np.asarray(rv), np.asarray(rl).astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_wigner_seeds_match_reference(grid, dtype):
	"""Both branches' seeds at lmax 200, s = 3, where log2 N passes the
	float32 band (m > ~61); the CC grid's first and last rings are the poles."""
	s, mmax, theta = 3, 200, GRIDS[grid]
	rv, rl = reference_seeds(grid, mmax, s)
	v, lv = sht_core.wigner_seeds(theta, mmax, s, dtype)
	assert v.shape == (2, mmax + 1, len(theta)) and lv.dtype == np.int32
	assert v.dtype == (np.float64 if dtype == torch.float64 else np.float32)
	S = sht_core.scale_log2(dtype)
	# the level is never above 0, and the value fits its band
	assert lv.max() <= 0 and np.abs(v).max() < 2.0**S
	# the reference's value brought to this level: true = rv 2^(850 rl) = v 2^(S lv)
	shift = 850*rl - S*lv.astype(np.int64)
	ref = np.ldexp(rv, np.clip(shift, -1000, 1000).astype(np.int32))
	# on a pole ring sin(theta/2) or cos(theta/2) is exactly 0 in the port and
	# cos(pi/2) = 6e-17 in the reference: the port's seed is 0 where the
	# reference's is a power of that
	pole = np.abs(np.sin(theta)) < 1e-12
	residue = pole & (np.abs(np.ldexp(rv, np.clip(850*rl, -1000, 0).astype(np.int32))) < 1e-15)
	assert (v[residue] == 0).all() and pole.sum() == (2 if grid == "CC" else 0)
	near = (np.abs(shift) < 1000) & (ref != 0) & ~residue
	tol = 1e-13 if dtype == torch.float64 else 1.2e-7
	assert (np.abs(v - ref)[near] <= tol*np.abs(ref[near])).all()
	assert (np.sign(v) == np.sign(ref))[near].all()
	# every seed above 2^-900 was compared
	true_log2 = np.log2(np.abs(v.astype(np.float64)) + 1e-300) + S*lv.astype(np.float64)
	assert near[(true_log2 > -900) & (v != 0)].all() and near.sum() > near.size//4


@pytest.mark.parametrize("s", [3, 4, 7])
def test_wigner_tables_match_reference(s):
	nl, nm = 64, 40
	t64 = sht_cuda.wigner_tables(nl, nm, s, torch.float64).numpy()
	t32 = sht_cuda.wigner_tables(nl, nm, s, torch.float32).numpy()
	assert t64.shape == (3, nl, nm) and t32.dtype == np.float32
	l = np.arange(nl, dtype=np.float64)[:, None]
	m = np.arange(nm, dtype=np.float64)[None, :]
	live = l > np.maximum(m, s)
	with np.errstate(divide="ignore", invalid="ignore"):
		v2 = lambda lv: (lv - m)*(lv + m)*(lv - s)*(lv + s)/(lv*lv*(4*lv*lv - 1))
		a = np.where(live, 1/np.sqrt(np.where(live, v2(l), 1.0)), 0.0)
		okb = live & (l - 1 > np.maximum(m, s))
		b = np.where(okb, np.sqrt(np.where(okb, v2(l - 1), 1.0)), 0.0)
		c = np.where(live, m*s/((l - 1)*l), 0.0)
	for got, want in zip(t64, (a, b, c)):
		assert np.abs(got - want).max() <= 1e-14*max(np.abs(want).max(), 1)
	assert (t64[:, ~live] == 0).all()
	# the reference's float32 tables: one per branch, c with the branch's sign
	for branch, sgn in ((0, 1.0), (1, -1.0)):
		ref = np.asarray(jpallas._wigner_ab_tables(nl, nm, s, branch))
		mine = t32*np.array([1.0, 1.0, sgn], np.float32)[:, None, None]
		assert (np.abs(mine - ref) <= 3*np.spacing(np.abs(ref))).all()


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------
def scan_inputs(lmax, nt, seed, C=4):
	rng = np.random.default_rng(seed)
	theta = (np.arange(nt) + 0.5)*np.pi/nt
	A = rng.standard_normal((lmax + 1, lmax + 1, C))
	F = rng.standard_normal((2, C, lmax + 1, nt))
	return theta, A, F


@pytest.mark.parametrize("s", [3, 4, 7])
def test_wigner_scans_match_reference_f64(s):
	"""Random, asymmetric A and F: a swapped branch sign for m < s or swapped
	exponents cannot cancel."""
	lmax = 48
	theta, A, F = scan_inputs(lmax, 2*lmax + 2, s)
	G = sht_core.wigner_synthesis_scan(torch.from_numpy(A), theta, lmax, lmax, s)
	assert G.shape == (2, 4, lmax + 1, len(theta)) and G.dtype == torch.float64
	assert relerr(G, jcore.wigner_synthesis_scan(A, theta, lmax, lmax, s)) < 1e-11
	a = sht_core.wigner_analysis_scan(torch.from_numpy(F), theta, lmax, lmax, s)
	assert a.shape == (lmax + 1, lmax + 1, 4)
	assert relerr(a, jcore.wigner_analysis_scan(F, theta, lmax, lmax, s)) < 1e-11


def test_wigner_scans_f32_lmax200():
	"""s = 3 at lmax 200 in float32 against the float64 reference: a seed
	left at level +1 (m > ~61) would show as an O(1) error."""
	s, lmax = 3, 200
	theta, A, F = scan_inputs(lmax, 2*lmax + 2, 5)
	G = sht_core.wigner_synthesis_scan(torch.from_numpy(A).float(), theta, lmax, lmax, s,
		dtype=torch.float32)
	assert G.dtype == torch.float32
	assert relerr(G, jcore.wigner_synthesis_scan(A, theta, lmax, lmax, s)) < 2e-4
	a = sht_core.wigner_analysis_scan(torch.from_numpy(F).float(), theta, lmax, lmax, s,
		dtype=torch.float32)
	assert relerr(a, jcore.wigner_analysis_scan(F, theta, lmax, lmax, s)) < 2e-4


def test_wigner_spin2_is_the_spin2_mode():
	"""The wigner engine at s = 2 against the port's spin2 mode, which
	reaches w and x from the Legendre recurrence: a wholly different route."""
	lmax = 48
	theta, A, F = scan_inputs(lmax, 2*lmax + 2, 2)
	A, F = torch.from_numpy(A), torch.from_numpy(F)
	assert relerr(sht_core.wigner_synthesis_scan(A, theta, lmax, lmax, 2),
		sht_core.synthesis_scan(A, theta, lmax, lmax, "spin2")) < 1e-11
	assert relerr(sht_core.wigner_analysis_scan(F, theta, lmax, lmax, 2),
		sht_core.analysis_scan(F, theta, lmax, lmax, "spin2")) < 1e-11


def test_wigner_mode_needs_its_geometry():
	theta, A, _ = scan_inputs(8, 18, 0, C=2)
	A = torch.from_numpy(A)
	with pytest.raises(ValueError):
		sht_core.synthesis(A, sht_core.prepare_geom(theta, 8, torch.float64), 8, "wigner")
	with pytest.raises(ValueError):
		sht_core.synthesis(A, sht_core.prepare_geom(theta, 8, torch.float64, s=3), 8, "spin2")
	with pytest.raises(ValueError):   # no half-sky form
		sht_cuda.sym_synthesis(A, sht_cuda.geom(theta[:9], 8, torch.float64, "cpu", 3), 8, "wigner")
	with pytest.raises(ValueError):
		sht_cuda.synthesis_scan(A, theta, 8, 8, "wigner", torch.float64)   # no s
	with pytest.raises(ValueError):
		sht_cuda.kernel_synthesis(A, theta, 8, 8, "spin2", torch.float64, 3)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_wigner_polar_split(monkeypatch):
	"""The near-pole split of the wigner dispatch on CPU tensors: the stitch
	indices, the m-extent Mp and the zero padding, with POLAR_AMP and
	POLAR_MMAX shrunk so that the m-truncated branch runs at a small size
	(after tests/test_pallas.py test_wigner_polar_split)."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 10.0)
	monkeypatch.setattr(sht_cuda, "POLAR_MMAX", 32)
	monkeypatch.setattr(jpallas, "POLAR_MMAX", 32)
	calls = []
	def spy(name):
		kern = getattr(sht_cuda, name)
		def wrapped(x, g, *args, **kw):
			calls.append((name, g.dtype, g.nt, g.nm - 1, g.s))
			return kern(x, g, *args, **kw)
		monkeypatch.setattr(sht_cuda, name, wrapped)
	spy("full_synthesis"); spy("full_analysis"); spy("polar_analysis"); spy("polar_synthesis")
	s, lmax = 3, 64
	theta, A, F = scan_inputs(lmax, 2*lmax + 2, 0, C=2)
	nt = len(theta)
	nn, ns = sht_cuda.polar_counts(theta, lmax)
	assert nn > 0 and ns > 0
	Mp = sht_cuda._polar_split(theta, lmax, lmax, s)[2]
	assert Mp == 32 == jpallas._wigner_polar_mmax(lmax, s)
	f32, f64 = torch.float32, torch.float64
	G = sht_cuda.kernel_synthesis(torch.from_numpy(A).float(), theta, lmax, lmax, "wigner", f32, s)
	assert G.dtype == f32
	assert relerr(G, jcore.wigner_synthesis_scan(A, theta, lmax, lmax, s)) < 2e-5
	# the near-pole pass goes through the redesigned float64 kernel, not K3
	assert calls == [("full_synthesis", f32, nt, lmax, s), ("polar_synthesis", f64, nn + ns, Mp - 1, s)]
	calls.clear()
	a = sht_cuda.kernel_analysis(torch.from_numpy(F).float(), theta, lmax, lmax, "wigner", f32, s)
	assert relerr(a, jcore.wigner_analysis_scan(F, theta, lmax, lmax, s)) < 2e-5
	# and through the redesigned float64 kernel, not K4
	assert calls == [("full_analysis", f32, nt - nn - ns, lmax, s),
		("polar_analysis", f64, nn + ns, Mp - 1, s)]
	# a large spin widens the near-pole pass to s + 1 rows
	assert sht_cuda._polar_split(theta, lmax, lmax, 40)[2] == 41 == jpallas._wigner_polar_mmax(lmax, 40)
	assert sht_cuda._polar_split(theta, 20, 20, 40)[2] == 21 == jpallas._wigner_polar_mmax(20, 40)
	# float64 runs one pass, symmetric ring set or not
	calls.clear()
	sht_cuda.kernel_synthesis(torch.from_numpy(A), theta, lmax, lmax, "wigner", f64, s)
	assert calls == [("full_synthesis", f64, nt, lmax, s)]
	assert all(v == 0 for v in sht_cuda.LAUNCHES_BY_DTYPE.values())   # no kernel on the CPU


# ---------------------------------------------------------------------------
# dead tiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [0, 3])
def test_dead_table_matches_reference(s):
	"""At the reference's own tile extents the two tables are equal."""
	for lmax, nt, tb in ((300, 602, 128), (750, 1434, 256), (2000, 2048, 512)):
		theta = (np.arange(nt) + 0.5)*np.pi/nt
		for th in (theta, theta[:-3], theta[nt//3:]):
			ref = jpallas._dead_table(th, lmax, lmax, tb, s=s)
			mine = sht_cuda.dead_table(th, lmax, lmax, jpallas.MB, tb, s)
			assert mine.dtype == bool and np.array_equal(mine, ref)
	# the port's own blocks: dead tiles already at lmax 750 on 900 rings
	th = sht.ring_theta("F1", 900)
	# as stop degrees: 0 on a dead block, lmax + 1 (run to the end) elsewhere
	lstop = sht_cuda.dead_stops(th, 750, 750, s, "cpu")
	assert lstop.dtype == torch.int32 and set(lstop.unique().tolist()) == {0, 751}
	assert tuple(lstop.shape) == (-(-751//sht_cuda.TILE_M), -(-900//sht_cuda.TILE_T))
	assert 0 < int((lstop == 0).sum()) < lstop.numel()//2
	assert np.array_equal(lstop.numpy() == 0,
		sht_cuda.dead_table(th, 750, 750, sht_cuda.TILE_M, sht_cuda.TILE_T, s))
	live = sht_cuda.live_mask(lstop, 751, 900)
	assert tuple(live.shape) == (751, 900) and not bool(live[700, 0])
	assert bool(live[:60].all()) and bool(live[:, 384:512].all())
	assert torch.equal(sht_cuda.stop_entries(lstop, 751, 900) > 0, live)
	assert sht_cuda.dead_stops(th[300:600], 750, 750, s, "cpu") is None   # equatorial rings


@pytest.mark.parametrize("mode,tol", [("scalar", 1e-9), ("spin2", 1e-7), ("wigner", 1e-7)])
def test_dead_tile_skip_is_negligible(mode, tol):
	"""K3/K4's plain versions with the dead tiles' stop degrees and without,
	in float32 as the main path launches them: the skipped tiles hold less
	than the bound, and the live ones are untouched."""
	lmax, C = 300, 2
	s = 3 if mode == "wigner" else None
	theta = (np.arange(2*lmax + 2) + 0.5)*np.pi/(2*lmax + 2)
	theta = theta[:-3]
	nt = len(theta)
	dead = sht_cuda.dead_stops(theta, lmax, lmax, s or 0, "cpu")
	assert dead is not None and int((dead == 0).sum()) > 0
	g = sht_cuda.geom(theta, lmax, torch.float32, "cpu", s)
	rng = np.random.default_rng(0)
	nfun = sht_core.NFUN[mode]
	A = torch.from_numpy(rng.standard_normal((lmax + 1, lmax + 1, C))).float()
	F = torch.from_numpy(rng.standard_normal((nfun, C, lmax + 1, nt))).float()
	G_skip = sht_cuda.full_synthesis(A, g, lmax, mode, dead)
	G_full = sht_cuda.full_synthesis(A, g, lmax, mode)
	live = sht_cuda.live_mask(dead, lmax + 1, nt)
	assert bool((G_skip[..., ~live] == 0).all())
	assert torch.equal(G_skip[..., live], G_full[..., live])
	assert relerr(G_skip, G_full) < tol
	a_skip = sht_cuda.full_analysis(F, g, lmax, mode, dead)
	a_full = sht_cuda.full_analysis(F, g, lmax, mode)
	assert relerr(a_skip, a_full) < tol
	with pytest.raises(ValueError):   # a table of another grid
		sht_cuda._mode_args(g, lmax + 1, mode, dead[:-1], torch.device("cpu"))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spin,ncomp", [([0, 3], 3), ([3], 2)], ids=["0-3", "3"])
def test_sht_spin3_matches_reference(spin, ncomp):
	lmax, mmax, nt, nphi, phi0 = 20, 17, 34, 48, 0.1
	theta = jsht.ring_theta("F1", nt)
	w = jsht.ring_weights("F1", nt)
	rng = np.random.default_rng(7)
	n = sht.nalm(lmax, mmax)
	alm = rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n))
	alm[:, :lmax + 1] = alm[:, :lmax + 1].real   # m = 0 is real
	m = sht.synthesis(torch.from_numpy(alm), theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=spin)
	mref = np.asarray(jsht.synthesis(alm, theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=spin))
	assert m.shape == (ncomp, nt, nphi) and relerr(m, mref) < 1e-10
	a = sht.analysis(m, theta, lmax, w, mmax=mmax, phi0=phi0, spin=spin)
	assert relerr(a, jsht.analysis(mref, theta, lmax, w, mmax=mmax, phi0=phi0, spin=spin)) < 1e-10
	F = sht.ring_analysis(m, phi0, mmax + 1)
	for kw in (dict(), dict(m_degeneracy=False, rect_out=True)):
		got = sht.adjoint_synthesis_phase(F, theta, lmax, mmax=mmax, spin=spin, **kw)
		ref = jsht.adjoint_synthesis_phase(F.numpy(), theta, lmax, mmax=mmax, spin=spin, **kw)
		assert relerr(got, ref) < 1e-10
	# the southern extension's (-1)^s sign with an odd s
	got = sht.resample_theta_phase(F, "F1", 50, curvedsky._comp_spins(spin, ncomp))
	ref = jsht.resample_theta_phase(F.numpy(), "F1", 50, curvedsky._comp_spins(spin, ncomp))
	assert relerr(got, ref) < 1e-10


def sky(lmax, ncomp, seed, spin):
	"""A random band-limited alm without the l < s modes a spin-s block cannot carry."""
	rng = np.random.default_rng(seed)
	n = sht.nalm(lmax)
	alm = rng.standard_normal((ncomp, n)) + 1j*rng.standard_normal((ncomp, n))
	alm[:, :lmax + 1] = alm[:, :lmax + 1].real
	l = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
	for i, s in enumerate(curvedsky._comp_spins(spin, ncomp)):
		alm[i, l < s] = 0
	return alm


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 5e-4)],
	ids=["f64", "f32"])
def test_curvedsky_spin03(dtype, tol):
	"""alm2map and map2alm with spin=[0, 3] on a small Fejer-1 map against
	pixell_tpu, and the alm roundtrip."""
	lmax, shape = 24, (30, 60)
	spin = [0, 3]
	alm = sky(lmax, 3, 11, spin)
	cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
	npdt = np.float64 if dtype == torch.float64 else np.float32
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	jshape, jwcs = jenmap.fullsky_geometry(shape=shape, variant="fejer1")
	talm = torch.from_numpy(alm).to(cdt)
	m = curvedsky.alm2map(talm, enmap.zeros((3,) + gshape, wcs, dtype, device="cpu"), spin=spin)
	mref = jcurvedsky.alm2map(alm, jenmap.zeros((3,) + jshape, jwcs, np.float64), spin=spin)
	assert m.data.dtype == dtype and relerr(m.data, mref) < tol
	a = curvedsky.map2alm(m, lmax=lmax, spin=spin)
	aref = jcurvedsky.map2alm(jenmap.ndmap(jnp.asarray(m.data.numpy().astype(np.float64)), jwcs),
		lmax=lmax, spin=spin)
	assert a.dtype == cdt and relerr(a, aref) < tol
	assert relerr(a, alm) < tol   # exact quadrature: the roundtrip returns the alm
	if dtype == torch.float64:
		a2 = curvedsky.map2alm(m, lmax=lmax, spin=spin, niter=1)
		assert relerr(a2, alm) < tol


def test_curvedsky_spin3_alone_and_rand_map():
	lmax, shape = 24, (30, 60)
	alm = sky(lmax, 2, 13, [3])
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	jshape, jwcs = jenmap.fullsky_geometry(shape=shape, variant="fejer1")
	m = curvedsky.alm2map(torch.from_numpy(alm), enmap.zeros((2,) + gshape, wcs, device="cpu"),
		spin=[3])
	mref = jcurvedsky.alm2map(alm, jenmap.zeros((2,) + jshape, jwcs, np.float64), spin=[3])
	assert relerr(m.data, mref) < 1e-10
	assert relerr(curvedsky.map2alm(m, lmax=lmax, spin=[3]), alm) < 1e-10
	assert curvedsky._comp_spins([0, 3], 3) == [0, 3, 3] == jcurvedsky._comp_spins([0, 3], 3)
	ps = np.zeros((3, 3, lmax + 1))
	for i, s in enumerate([0, 3, 3]): ps[i, i, s:] = 1.0
	r = curvedsky.rand_map((3,) + gshape, wcs, ps, lmax=lmax, seed=3, spin=[0, 3], device="cpu")
	assert tuple(r.shape) == (3,) + tuple(gshape) and bool(torch.isfinite(r.data).all())
	back = curvedsky.map2alm(r, lmax=lmax, spin=[0, 3])
	again = curvedsky.alm2map(back, enmap.zeros((3,) + gshape, wcs, device="cpu"), spin=[0, 3])
	assert relerr(again.data, r.data) < 1e-10
