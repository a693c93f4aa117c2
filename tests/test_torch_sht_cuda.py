"""The Legendre kernel dispatch (pixell_tpu_torch.ops.sht_cuda) on the CPU,
with each kernel's plain PyTorch version standing in for the kernel, held
against pixell_tpu: its host-side preparation (symmetry detection, polar
ring counts, recurrence tables, two-part cos theta) and, end to end, the
plain float64 reference scan of pixell_tpu.ops.sht_core.

Tolerances, relative to the largest reference value:
- float64 dispatch: 1e-10 (same algorithm, other summation order, and the
  half-sky paths fold the mirror rings by parity).
- float32 dispatch: 2e-5, the bound of tests/test_pallas.py for the f32
  kernels; the near-pole rings go through the float64 pass.
The CUDA kernels themselves run only on a GPU; chip_smoke.py holds them
against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu.ops import sht_core as jcore, sht_pallas as jpallas
from pixell_tpu_torch.ops import sht_cuda, sht_core

LMAX = 24


def ring_sets():
	rng = np.random.default_rng(5)
	return {
		"F1-even": (np.arange(52) + 0.5)*np.pi/52,
		"F1-odd": (np.arange(53) + 0.5)*np.pi/53,
		"CC": np.arange(51)*np.pi/50,
		"asym": np.sort(np.concatenate([rng.uniform(0.02, 3.1, 46), [1e-3, np.pi - 2e-3]])),
	}


def test_host_preparation_matches_reference():
	for name, theta in ring_sets().items():
		assert sht_cuda.detect_sym(theta) == jpallas._detect_sym(theta), name
		for lmax in (24, 300, 2000):
			assert sht_cuda.polar_counts(theta, lmax) == jpallas._polar_counts(theta, lmax)
	# too many rings for the half-sky kernels
	big = (np.arange(3074) + 0.5)*np.pi/3074
	assert sht_cuda.detect_sym(big) is None and jpallas._detect_sym(big) is None
	# within one f32 ulp: the tables are numpy's correctly rounded numbers
	# (sht_cuda.host_coef), while XLA's CPU f32 sqrt and divide are off by one
	# ulp on a few entries
	ab = sht_cuda.coef_tables(40, 33, torch.float32)
	np.testing.assert_allclose(ab[:2].numpy(), np.asarray(jpallas._recur_ab_tables(40, 33)),
		rtol=1.2e-7, atol=0)
	# the tables and the plain scan's per-step coefficients are the same
	# formulas: within one ulp, since torch's CPU sqrt is not always correctly
	# rounded
	marr = torch.arange(33, dtype=torch.float64)
	ab64 = sht_cuda.coef_tables(40, 33, torch.float64)
	for l in (0, 1, 7, 39):
		a, b = sht_core.recur_ab(l, marr)
		for got, want in ((ab64[0, l], a), (ab64[1, l], b), (ab64[2, l], sht_core.recur_e(l, marr))):
			np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)
	for mode in ("deriv", "spin1", "spin2"):
		lt = sht_cuda.l_tables(40, mode, torch.float64)
		for l in (0, 1, 2, 39):
			nrm, hp = sht_core.l_norms(mode, torch.tensor(float(l), dtype=torch.float64))
			np.testing.assert_array_max_ulp(lt[:, l].numpy(), np.array([float(nrm), float(hp)]),
				maxulp=1)


@pytest.mark.parametrize("rings", ["F1-even", "F1-odd", "CC", "asym"])
def test_dispatch_matches_reference(rings, monkeypatch):
	"""K1-K4 dispatch with the plain kernels, including the near-pole pass:
	POLAR_AMP is lowered so that LMAX 24 has both polar and bulk rings."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	theta = ring_sets()[rings]
	nn, ns = sht_cuda.polar_counts(theta, LMAX)
	assert 0 < nn + ns < len(theta)
	lmax, mmax = LMAX, LMAX - 2
	rng = np.random.default_rng(1)
	A = rng.standard_normal((lmax + 1, mmax + 1, 3))
	F = rng.standard_normal((1, 3, mmax + 1, len(theta)))
	G64 = np.asarray(jcore.synthesis_scan(jnp.asarray(A), theta, lmax, mmax, dtype=np.float64))
	a64 = np.asarray(jcore.analysis_scan(jnp.asarray(F), theta, lmax, mmax, dtype=np.float64))
	before = dict(sht_cuda.LAUNCHES)
	for dt, tol in [(torch.float64, 1e-10), (torch.float32, 2e-5)]:
		G = sht_cuda.kernel_synthesis(torch.from_numpy(A), theta, lmax, mmax, dtype=dt)
		a = sht_cuda.kernel_analysis(torch.from_numpy(F), theta, lmax, mmax, dtype=dt)
		assert G.shape == G64.shape and G.dtype == dt
		assert a.shape == a64.shape and a.dtype == dt
		assert np.abs(G.double().numpy() - G64).max() <= tol*np.abs(G64).max(), (rings, dt)
		assert np.abs(a.double().numpy() - a64).max() <= tol*np.abs(a64).max(), (rings, dt)
	# the plain versions are not kernel launches
	assert sht_cuda.LAUNCHES == before


def test_polar_pass_is_float64(monkeypatch):
	"""The f32 dispatch overwrites the near-pole rings (m < POLAR_MMAX) of the
	synthesis with the float64 pass, and adds their analysis contribution."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	monkeypatch.setattr(sht_cuda, "POLAR_MMAX", 9)
	theta = ring_sets()["F1-even"]
	lmax = mmax = LMAX
	nn, ns = sht_cuda.polar_counts(theta, lmax)
	nt = len(theta)
	rng = np.random.default_rng(2)
	A = torch.from_numpy(rng.standard_normal((lmax + 1, mmax + 1, 2)))
	G32 = sht_cuda.kernel_synthesis(A, theta, lmax, mmax, dtype=torch.float32)[0]
	G64 = sht_core.synthesis_scan(A, theta, lmax, mmax, dtype=torch.float64)[0]
	bulk = sht_core.synthesis_scan(A, theta, lmax, mmax, dtype=torch.float32)[0]
	pol = np.r_[0:nn, nt-ns:nt]
	assert torch.equal(G32[:, :9][..., pol], G64[:, :9][..., pol].float())
	assert torch.equal(G32[:, 9:], bulk[:, 9:])
	F = torch.from_numpy(rng.standard_normal((1, 2, mmax + 1, nt)))
	a32 = sht_cuda.kernel_analysis(F, theta, lmax, mmax, dtype=torch.float32)
	Fp = F.clone(); Fp[..., nn:nt-ns] = 0; Fp[:, :, 9:] = 0
	Fb = F.clone(); Fb[..., pol] = 0
	want = sht_core.analysis_scan(Fb, theta, lmax, mmax, dtype=torch.float32) \
		+ sht_core.analysis_scan(Fp, theta, lmax, mmax, dtype=torch.float64).float()
	assert torch.allclose(a32, want, rtol=0, atol=1e-5*float(want.abs().max()))


def test_other_devices_raise():
	"""Only CPU tensors take the plain versions; a tensor on any device
	other than CPU or CUDA raises instead of running them."""
	theta = ring_sets()["asym"]
	A = torch.zeros((5, 5, 2), device="meta")
	F = torch.zeros((1, 2, 5, len(theta)), device="meta")
	with pytest.raises(RuntimeError, match="no Legendre kernel"):
		sht_cuda.synthesis_scan(A, theta, 4, 4)
	with pytest.raises(RuntimeError, match="no Legendre kernel"):
		sht_cuda.analysis_scan(F, theta, 4, 4)
	g = sht_cuda.geom(theta, 4, torch.float32, "meta")
	for name, x in [("full_synthesis", A), ("sym_synthesis", A), ("full_analysis", F),
			("sym_analysis", torch.zeros((1, 2, 2, 5, len(theta)), device="meta"))]:
		with pytest.raises(RuntimeError, match="no Legendre kernel"):
			getattr(sht_cuda, name)(x, g, 4)


def test_wrapper_checks():
	theta = ring_sets()["asym"]
	g = sht_cuda.geom(theta, 4, torch.float32, "cpu")
	with pytest.raises(TypeError):
		sht_cuda.full_synthesis(torch.zeros((5, 5, 2), dtype=torch.float64), g, 4)
	with pytest.raises(ValueError):
		sht_cuda.full_synthesis(torch.zeros((6, 5, 2)), g, 4)
	with pytest.raises(ValueError):
		sht_cuda.full_analysis(torch.zeros((2, 5, 3)), g, 4)
	with pytest.raises(ValueError):   # spin2 takes two mode functions
		sht_cuda.full_analysis(torch.zeros((1, 4, 5, len(theta))), g, 4, mode="spin2")
	with pytest.raises(ValueError):
		sht_cuda.sym_synthesis(torch.zeros((5, 5, 4)), g, 4, mode="spin3")
	assert sht_cuda.geom(theta, 4, torch.float32, "cpu") is g   # cached per ring set
	assert sht_cuda._col_chunks(4) == [(0, 4)] and sht_cuda._col_chunks(6) == [(0, 4), (4, 6)]
	with pytest.raises(ValueError):   # no kernel takes an odd column count
		sht_cuda._col_chunks(7)


@pytest.mark.parametrize("mode", ["deriv", "spin1", "spin2"])
def test_dispatch_spin_modes(mode, monkeypatch):
	"""The dispatch in modes deriv, spin1 and spin2 (C = 4 columns) with the
	plain kernels, on every ring set, against pixell_tpu.ops.sht_core's
	float64 scan, with POLAR_AMP lowered so that both the bulk and the
	near-pole pass run. The inputs are independent random values on every
	ring, so north != +-south and a wrong PSIGN in the half-sky E/O fold or
	mirror cannot cancel. The reference runs once on the union of the ring
	sets (the scan is per ring; the analysis is linear, so each set's is
	the union's with F zero elsewhere). Bounds as
	test_dispatch_matches_reference: 1e-10 (f64); 2e-5 (f32), measured
	<= 3e-6 here because the near-pole rings run in float64."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	sets = ring_sets()
	union = np.concatenate(list(sets.values()))
	lmax, mmax, C = LMAX, LMAX - 2, 4
	nfun = sht_core.NFUN[mode]
	rng = np.random.default_rng(7)
	A = rng.standard_normal((lmax + 1, mmax + 1, C))
	Fu = rng.standard_normal((nfun, C, mmax + 1, len(union)))
	Gu = np.asarray(jcore.synthesis_scan(jnp.asarray(A), union, lmax, mmax, mode=mode,
		dtype=np.float64))
	i0 = 0
	for name, theta in sets.items():
		sl = slice(i0, i0 + len(theta)); i0 += len(theta)
		G64, F = Gu[..., sl], Fu[..., sl]
		Fz = np.zeros_like(Fu); Fz[..., sl] = F
		a64 = np.asarray(jcore.analysis_scan(jnp.asarray(Fz), union, lmax, mmax, mode=mode,
			dtype=np.float64))
		for dt, tol in [(torch.float64, 1e-10), (torch.float32, 2e-5)]:
			G = sht_cuda.kernel_synthesis(torch.from_numpy(A), theta, lmax, mmax, mode, dt)
			a = sht_cuda.kernel_analysis(torch.from_numpy(np.ascontiguousarray(F)), theta, lmax,
				mmax, mode, dt)
			assert G.shape == G64.shape == (nfun, C, mmax + 1, len(theta)) and G.dtype == dt
			assert a.shape == a64.shape and a.dtype == dt
			assert np.abs(G.double().numpy() - G64).max() <= tol*np.abs(G64).max(), (name, dt)
			assert np.abs(a.double().numpy() - a64).max() <= tol*np.abs(a64).max(), (name, dt)
	# the plain versions are not kernel launches
	assert all(v == 0 for v in sht_cuda.LAUNCHES_BY_MODE.values())


@pytest.mark.parametrize("mode", ["deriv", "spin1", "spin2"])
def test_half_sky_parity(mode):
	"""K1/K2's plain versions against the full-sky scan on the mirrored
	rings: the mirror plane of K1 is the synthesis at pi - theta, and K2 of
	the even/odd planes equals the full analysis of north and south rings
	given separately -- on random, asymmetric values (float64, 1e-12: the
	same recurrence, mirrored exactly)."""
	lmax, mmax, C = 20, 17, 4
	th = (np.arange(22) + 0.5)*np.pi/44          # northern rings only
	full = np.concatenate([th, np.pi - th[::-1]])
	nfun, nh = sht_core.NFUN[mode], len(th)
	rng = np.random.default_rng(11)
	A = torch.from_numpy(rng.standard_normal((lmax + 1, mmax + 1, C)))
	gN = sht_cuda.geom(th, mmax, torch.float64, "cpu")
	gF = sht_cuda.geom(full, mmax, torch.float64, "cpu")
	pair = sht_cuda.sym_synthesis(A, gN, lmax, mode)
	G = sht_cuda.full_synthesis(A, gF, lmax, mode)
	assert pair.shape == (nfun, C, 2, mmax + 1, nh)
	scale = float(G.abs().max())
	assert float((pair[:, :, 0] - G[..., :nh]).abs().max()) <= 1e-12*scale
	assert float((pair[:, :, 1] - G[..., nh:].flip(-1)).abs().max()) <= 1e-12*scale
	F = torch.from_numpy(rng.standard_normal((nfun, C, mmax + 1, 2*nh)))
	north, south = F[..., :nh], F[..., nh:].flip(-1)
	EO = torch.stack([north + south, north - south], 2)
	a = sht_cuda.sym_analysis(EO, gN, lmax, mode)
	want = sht_cuda.full_analysis(F, gF, lmax, mode)
	assert float((a - want).abs().max()) <= 1e-12*float(want.abs().max())


def test_polar_pass_spin2(monkeypatch):
	"""In spin2 mode, the f32 dispatch overwrites the near-pole rings
	(m < POLAR_MMAX) of both mode functions with the float64 pass, and adds
	the near-pole rings' analysis contribution from the float64 pass."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	monkeypatch.setattr(sht_cuda, "POLAR_MMAX", 9)
	theta = ring_sets()["CC"]
	lmax = mmax = LMAX
	nn, ns = sht_cuda.polar_counts(theta, lmax)
	nt = len(theta)
	pol = np.r_[0:nn, nt-ns:nt]
	rng = np.random.default_rng(3)
	A = torch.from_numpy(rng.standard_normal((lmax + 1, mmax + 1, 4)))
	G32 = sht_cuda.kernel_synthesis(A, theta, lmax, mmax, "spin2", torch.float32)
	G64 = sht_core.synthesis_scan(A, theta, lmax, mmax, "spin2", dtype=torch.float64)
	bulk = sht_core.synthesis_scan(A, theta, lmax, mmax, "spin2", dtype=torch.float32)
	assert torch.equal(G32[..., :9, :][..., pol], G64[..., :9, :][..., pol].float())
	assert torch.equal(G32[..., 9:, :], bulk[..., 9:, :])
	F = torch.from_numpy(rng.standard_normal((2, 4, mmax + 1, nt)))
	a32 = sht_cuda.kernel_analysis(F, theta, lmax, mmax, "spin2", torch.float32)
	Fp = F.clone(); Fp[..., nn:nt-ns] = 0; Fp[..., 9:, :] = 0
	Fb = F.clone(); Fb[..., pol] = 0
	want = sht_core.analysis_scan(Fb, theta, lmax, mmax, "spin2", dtype=torch.float32) \
		+ sht_core.analysis_scan(Fp, theta, lmax, mmax, "spin2", dtype=torch.float64).float()
	assert torch.allclose(a32, want, rtol=0, atol=1e-5*float(want.abs().max()))
