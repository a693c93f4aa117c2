"""The plain PyTorch Legendre scan (pixell_tpu_torch.ops.sht_core) against
pixell_tpu.ops.sht_core on the same numpy inputs.

Tolerances, relative to the largest reference value:
- float64: 1e-10. The same algorithm; only the summation and rounding
  order differ (torch does not fuse multiply-adds, XLA may).
- float32: 2e-5, the bound tests/test_pallas.py sets for the f32 kernels.
  Both scans lose ~l*eps, most on the near-pole rings, so each f32 result
  is held against the float64 reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp

from pixell_tpu.ops import sht_core as jcore, sht_pallas as jpallas
from pixell_tpu_torch.ops import sht_core

LMAX = 24


def ring_sets():
	rng = np.random.default_rng(2)
	return {
		"F1": (np.arange(2*LMAX + 2) + 0.5)*np.pi/(2*LMAX + 2),
		"CC": np.arange(2*LMAX + 3)*np.pi/(2*LMAX + 2),
		# asymmetric, with rings right at the poles' doorstep
		"asym": np.sort(np.concatenate([rng.uniform(0.05, 3.0, 2*LMAX),
			[2e-3, 1e-2, np.pi - 4e-3]])),
	}


@pytest.mark.parametrize("rings", ["F1", "CC", "asym"])
def test_scan_matches_reference(rings):
	theta = ring_sets()[rings]
	lmax, mmax, C = LMAX, LMAX - 3, 2
	rng = np.random.default_rng(0)
	A = rng.standard_normal((lmax + 1, mmax + 1, C))
	F = rng.standard_normal((1, C, mmax + 1, len(theta)))
	G64 = np.asarray(jcore.synthesis_scan(jnp.asarray(A), theta, lmax, mmax, dtype=np.float64))
	a64 = np.asarray(jcore.analysis_scan(jnp.asarray(F), theta, lmax, mmax, dtype=np.float64))
	for dt, tol in [(torch.float64, 1e-10), (torch.float32, 2e-5)]:
		G = sht_core.synthesis_scan(torch.from_numpy(A), theta, lmax, mmax, dtype=dt)
		a = sht_core.analysis_scan(torch.from_numpy(F), theta, lmax, mmax, dtype=dt)
		assert G.shape == G64.shape and G.dtype == dt
		assert a.shape == a64.shape and a.dtype == dt
		assert np.abs(G.double().numpy() - G64).max() <= tol*np.abs(G64).max(), (rings, dt)
		assert np.abs(a.double().numpy() - a64).max() <= tol*np.abs(a64).max(), (rings, dt)


def test_seeds_match_reference():
	"""The scaled lambda_mm seeds, unscaled, against the reference's float64
	seeds: to a few ulp in float64, and in float32 at least as close as the
	reference's own float32 seeds (the port's running product is taken in
	float64 and rounded once). The two-part cos(theta) matches the
	reference's (sht_pallas._ct_parts) exactly."""
	theta = ring_sets()["asym"]
	mmax = 120
	# one jitted program per dtype: eager dispatch compiles op by op
	prep = jax.jit(jcore._prepare_geom, static_argnums=(1, 2))
	unscale = lambda v, l, S: np.asarray(v, np.float64)*np.exp2(S*np.asarray(l, np.float64))
	ref = prep(theta, mmax, np.float64)
	want = unscale(ref["seed_val"], ref["seed_level"], 850)
	err = lambda x: np.abs(x - want).max(axis=1)/np.abs(want).max(axis=1)
	g = sht_core.prepare_geom(theta, mmax, torch.float64)
	assert sht_core.scale_log2(torch.float64) == jcore._scale_log2(np.float64)
	assert np.all(err(unscale(g.seed_val.numpy(), g.seed_level.numpy(), 850)) < 1e-14)
	ref32 = prep(theta, mmax, np.float32)
	g32 = sht_core.prepare_geom(theta, mmax, torch.float32)
	assert sht_core.scale_log2(torch.float32) == jcore._scale_log2(np.float32) == 60
	e_port = err(unscale(g32.seed_val.numpy(), g32.seed_level.numpy(), 60))
	e_ref = err(unscale(ref32["seed_val"], ref32["seed_level"], 60))
	assert np.all(e_port <= np.maximum(e_ref, 1.2e-7))
	cth, ctl = jpallas._ct_parts(theta)
	np.testing.assert_array_equal(g32.ct.numpy(), np.asarray(cth))
	np.testing.assert_array_equal(g32.ct_lo.numpy(), np.asarray(ctl))
	np.testing.assert_array_equal(g.ct.numpy(), np.cos(theta))
	assert not g.ct_lo.any()


def spin_ring_sets():
	"""Three ring sets of one size (the reference's jitted scan then compiles
	once per mode): Fejer-1, Clenshaw-Curtis with both pole rows (where the
	m = 1 and m = 2 pole limits act), and an asymmetric set with rings near
	the poles."""
	nt = 2*LMAX + 2
	rng = np.random.default_rng(4)
	return {
		"F1": (np.arange(nt) + 0.5)*np.pi/nt,
		"CC": np.arange(nt)*np.pi/(nt - 1),
		"asym": np.sort(np.concatenate([rng.uniform(0.05, 3.0, nt - 3),
			[2e-3, 1e-2, np.pi - 4e-3]])),
	}


# float32 bounds of the reference's own f32 kernels (tests/test_pallas.py:21-22)
F32_BOUND = {"deriv": 1.2e-5, "spin1": 1.2e-5, "spin2": 1e-4}


@pytest.mark.parametrize("rings", ["F1", "CC", "asym"])
@pytest.mark.parametrize("mode", ["deriv", "spin1", "spin2"])
def test_spin_modes_match_reference(mode, rings):
	"""The deriv, spin1 and spin2 modes of the plain scan against
	pixell_tpu.ops.sht_core with mode=, on asymmetric random inputs.
	float64: 1e-10 of the largest value (same formulas, other rounding
	order). float32, on the CC set: the reference's own f32 kernel bounds,
	relative to max(largest value, 1) as there. The plain f32 scan (like the
	reference's own f32 scan) amplifies rounding by ~1/sin^2 on rings nearer
	the poles than the CC set's; the f32 dispatch runs those rings in float64
	(tests/test_torch_sht_cuda.py)."""
	theta = spin_ring_sets()[rings]
	lmax, mmax, C = LMAX, LMAX - 3, 4
	nfun = sht_core.NFUN[mode]
	rng = np.random.default_rng(1)
	A = rng.standard_normal((lmax + 1, mmax + 1, C))
	F = rng.standard_normal((nfun, C, mmax + 1, len(theta)))
	G64 = np.asarray(jcore.synthesis_scan(jnp.asarray(A), theta, lmax, mmax, mode=mode,
		dtype=np.float64))
	a64 = np.asarray(jcore.analysis_scan(jnp.asarray(F), theta, lmax, mmax, mode=mode,
		dtype=np.float64))
	cases = [(torch.float64, 1e-10, np.abs(G64).max(), np.abs(a64).max())]
	if rings == "CC":
		cases.append((torch.float32, F32_BOUND[mode], max(np.abs(G64).max(), 1),
			max(np.abs(a64).max(), 1)))
	for dt, tol, gscale, ascale in cases:
		G = sht_core.synthesis_scan(torch.from_numpy(A), theta, lmax, mmax, mode=mode, dtype=dt)
		a = sht_core.analysis_scan(torch.from_numpy(F), theta, lmax, mmax, mode=mode, dtype=dt)
		assert G.shape == G64.shape == (nfun, C, mmax + 1, len(theta)) and G.dtype == dt
		assert a.shape == a64.shape and a.dtype == dt
		assert np.abs(G.double().numpy() - G64).max() <= tol*gscale, (mode, rings, dt)
		assert np.abs(a.double().numpy() - a64).max() <= tol*ascale, (mode, rings, dt)


def test_mode_rows_match_reference():
	"""cos/sin, 1/sin, 1/sin^2 and the pole flag against the reference's
	host-built rows, with the pole threshold of each dtype (a CC set has
	rings exactly at both poles)."""
	theta = spin_ring_sets()["CC"]
	for dt, jdt in [(torch.float64, np.float64), (torch.float32, np.float32)]:
		# eager: the reference builds these rows on the host only for concrete theta
		ref = jcore._prepare_geom(theta, 0, jdt)
		g = sht_core.prepare_geom(theta, 0, dt)
		for k in ("ct_st", "inv_st", "inv_st2", "notpole"):
			np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(ref[k]), err_msg=k)
		assert g.notpole[0] == 0 and g.notpole[-1] == 0 and g.notpole[1:-1].all()


def test_e_table_is_factored():
	"""e_lm = sqrt((l-m)(l+m)(2l+1)/(2l-1)): identical to the reference's
	f32 l*l - m*m form while l*l < 2^24 (l <= 4096), and still correctly
	rounded within one ulp of the float64 value above it, where l*l - m*m
	cancels."""
	m = torch.arange(4097, dtype=torch.float32)
	for l in (7, 4096):
		lf = torch.tensor(float(l))
		ref = torch.sqrt(torch.clamp((lf*lf - m*m)*(2*lf + 1), min=0)/torch.clamp(2*lf - 1, min=1))
		assert torch.equal(sht_core.recur_e(l, m), ref)
	l, m = 6000, torch.tensor([5999.0])
	exact = np.sqrt((l - 5999.0)*(l + 5999.0)*(2*l + 1)/(2*l - 1))
	assert abs(float(sht_core.recur_e(l, m)[0]) - exact) <= 2e-7*exact
