"""pixell_tpu_torch.sht against pixell_tpu.sht in float64: the alm layout
gathers against the reference's pad/reshape fold, the ring FFT stage, the
exact theta resample of phase coefficients, and the spin-0, spin-1, spin-2
and derivative transforms.

Tolerance 1e-10 relative to the largest reference value: the same
algorithms in float64; only the FFT library and the summation order differ
(the layout gathers are exact).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import sht as jsht, curvedsky as jcurvedsky
from pixell_tpu_torch import sht, curvedsky

TOL = 1e-10


def close(got, want, tol=TOL):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	assert np.abs(got - want).max() <= tol*np.abs(want).max()


def crandn(rng, shape):
	return rng.standard_normal(shape) + 1j*rng.standard_normal(shape)


@pytest.mark.parametrize("lmax,mmax", [(17, 17), (17, 9)])
def test_alm_layout(lmax, mmax):
	rng = np.random.default_rng(0)
	alm = crandn(rng, (2, sht.nalm(lmax, mmax)))
	assert sht.nalm(lmax, mmax) == jsht.nalm(lmax, mmax)
	assert sht.nalm2lmax(sht.nalm(lmax)) == lmax
	np.testing.assert_array_equal(sht.lm2ind(lmax, [3, 9], [2, 4]), jsht.lm2ind(lmax, [3, 9], [2, 4]))
	rect = sht.alm2rect(torch.from_numpy(alm), lmax, mmax)
	np.testing.assert_array_equal(rect.numpy(), np.asarray(jsht.alm2rect(alm, lmax, mmax)))
	back = sht.rect2alm(rect, lmax, mmax)
	np.testing.assert_array_equal(back.numpy(), alm)
	r = crandn(rng, (lmax + 1, mmax + 1))
	np.testing.assert_array_equal(sht.rect2alm(torch.from_numpy(r), lmax, mmax).numpy(),
		np.asarray(jsht.rect2alm(r, lmax, mmax)))


@pytest.mark.parametrize("nm,nphi", [(9, 24), (13, 24), (20, 25)])
def test_ring_fft(nm, nphi):
	"""Both the direct half-spectrum path and the aliasing path
	(nm > nphi/2), with a nonzero phi0."""
	rng = np.random.default_rng(1)
	G = crandn(rng, (2, nm, 7))
	G[..., 0, :] = G[..., 0, :].real
	phi0 = 0.3
	close(sht.ring_synthesis(torch.from_numpy(G), phi0, nphi), jsht.ring_synthesis(G, phi0, nphi))
	maps = rng.standard_normal((2, 7, nphi))
	close(sht.ring_analysis(torch.from_numpy(maps), phi0, nm), jsht.ring_analysis(maps, phi0, nm))


@pytest.mark.parametrize("variant,nt,nt_out", [("F1", 20, 45), ("CC", 21, 45), ("F1", 20, 32)])
def test_resample_theta_phase(variant, nt, nt_out, monkeypatch):
	rng = np.random.default_rng(2)
	F = crandn(rng, (1, 11, nt))
	want = jsht._resample_theta_phase_jit(jnp.asarray(F), variant, nt_out, (0,), 0)
	close(sht.resample_theta_phase(torch.from_numpy(F), variant, nt_out, [0]), want)
	# the m-chunked path gives the same numbers (chunk offsets carry (-1)^m)
	monkeypatch.setattr(sht, "MCHUNK_RESAMPLE", 4)
	close(sht.resample_theta_phase(torch.from_numpy(F), variant, nt_out, [0]), want)


@pytest.mark.parametrize("variant", ["F1", "CC"])
def test_ring_weights_and_theta(variant):
	for n in (9, 32):
		np.testing.assert_array_equal(sht.ring_theta(variant, n), jsht.ring_theta(variant, n))
		np.testing.assert_allclose(sht.ring_weights(variant, n), jsht.ring_weights(variant, n),
			rtol=0, atol=1e-15)


def test_spin0_transforms():
	"""synthesis, adjoint_synthesis, analysis and analysis_phase, with two
	components, mmax < lmax and phi0 != 0, on an F1 grid fine enough for
	exact quadrature."""
	lmax, mmax, nt, nphi, phi0 = 15, 12, 34, 40, 0.1
	theta = jsht.ring_theta("F1", nt)
	w = jsht.ring_weights("F1", nt)
	rng = np.random.default_rng(3)
	alm = crandn(rng, (2, sht.nalm(lmax, mmax)))
	alm[:, :lmax + 1] = alm[:, :lmax + 1].real
	ta = torch.from_numpy(alm)
	m = sht.synthesis(ta, theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=[0])
	close(m, jsht.synthesis(alm, theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=[0]))
	mn = m.numpy()
	close(sht.adjoint_synthesis(m, theta, lmax, mmax=mmax, phi0=phi0, spin=[0]),
		jsht.adjoint_synthesis(mn, theta, lmax, mmax=mmax, phi0=phi0, spin=[0]))
	a = sht.analysis(m, theta, lmax, w, mmax=mmax, phi0=phi0, spin=[0])
	close(a, jsht.analysis(mn, theta, lmax, w, mmax=mmax, phi0=phi0, spin=[0]))
	close(a, alm)   # exact quadrature: the analysis inverts the synthesis
	F = sht.ring_analysis(m, phi0, mmax + 1)
	close(sht.analysis_phase(F, theta, lmax, w, nphi, mmax=mmax, spin=[0]),
		jsht.analysis_phase(F.numpy(), theta, lmax, w, nphi, mmax=mmax, spin=[0]))


def spin_setup(ncomp, lmax=15, mmax=12, nt=34):
	theta = jsht.ring_theta("F1", nt)
	rng = np.random.default_rng(4)
	alm = crandn(rng, (ncomp, sht.nalm(lmax, mmax)))
	alm[:, :lmax + 1] = alm[:, :lmax + 1].real
	return theta, jsht.ring_weights("F1", nt), alm


# the IQU case runs on the __graft_entry__ step's grid (test_graft_entry_step),
# so the two share the reference's compiled scans
@pytest.mark.parametrize("spin,ncomp,lmax,mmax,nt,nphi,phi0",
	[((0, 2), 3, 32, 32, 66, 68, 0.0), ([1], 2, 15, 12, 34, 40, 0.1)], ids=["IQU", "spin1"])
def test_spin_transforms(spin, ncomp, lmax, mmax, nt, nphi, phi0):
	"""synthesis, adjoint_synthesis, analysis and analysis_phase with spin
	(0, 2) on three components (T, then Q/U) and spin [1] on two (with
	mmax < lmax and phi0 != 0), against pixell_tpu.sht (1e-10)."""
	theta, w, alm = spin_setup(ncomp, lmax, mmax, nt)
	m = sht.synthesis(torch.from_numpy(alm), theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax,
		spin=spin)
	jm = np.asarray(jsht.synthesis(alm, theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=spin))
	close(m, jm)
	close(sht.adjoint_synthesis(m, theta, lmax, mmax=mmax, phi0=phi0, spin=spin),
		jsht.adjoint_synthesis(jm, theta, lmax, mmax=mmax, phi0=phi0, spin=spin))
	close(sht.analysis(m, theta, lmax, w, mmax=mmax, phi0=phi0, spin=spin),
		jsht.analysis(jm, theta, lmax, w, mmax=mmax, phi0=phi0, spin=spin))
	F = sht.ring_analysis(m, phi0, mmax + 1)
	close(sht.analysis_phase(F, theta, lmax, w, nphi, mmax=mmax, spin=spin),
		jsht.analysis_phase(F.numpy(), theta, lmax, w, nphi, mmax=mmax, spin=spin))


def test_deriv_transforms():
	"""deriv=True: the (d/dtheta, d/dphi) synthesis of one alm and its
	analysis / adjoint from [2, nt, nphi], against pixell_tpu.sht (1e-10)."""
	lmax, mmax, nphi, phi0 = 15, 12, 40, 0.1
	theta, w, alm = spin_setup(1, lmax, mmax)
	m = sht.synthesis(torch.from_numpy(alm[0]), theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax,
		deriv=True)
	jm = np.asarray(jsht.synthesis(alm[0], theta, nphi, phi0=phi0, lmax=lmax, mmax=mmax,
		deriv=True))
	assert m.shape == (2, len(theta), nphi)
	close(m, jm)
	close(sht.analysis(m, theta, lmax, w, mmax=mmax, phi0=phi0, deriv=True),
		jsht.analysis(jm, theta, lmax, w, mmax=mmax, phi0=phi0, deriv=True))
	close(sht.adjoint_synthesis(m, theta, lmax, mmax=mmax, phi0=phi0, deriv=True),
		jsht.adjoint_synthesis(jm, theta, lmax, mmax=mmax, phi0=phi0, deriv=True))


def test_graft_entry_step():
	"""The framework's flagship step (__graft_entry__.entry): sht.analysis with
	spin (0, 2) on three maps, almxfl, sht.synthesis, at lmax 32 on a fine
	enough F1 grid, in float64 (1e-10) against the same step built from
	pixell_tpu."""
	lmax = 32
	nt, nphi = 2*lmax + 2, 2*lmax + 4
	theta, w = jsht.ring_theta("F1", nt), jsht.ring_weights("F1", nt)
	l = np.arange(lmax + 1)
	fl = np.exp(-0.5*l*(l + 1)*0.003**2)
	maps = np.random.default_rng(0).standard_normal((3, nt, nphi))
	ja = jsht.analysis(maps, theta, lmax, w, spin=(0, 2))
	ja = jcurvedsky.almxfl(ja, fl, ainfo=jcurvedsky.alm_info(lmax=lmax))
	jout = jsht.synthesis(ja, theta, nphi, lmax=lmax, spin=(0, 2))
	a = sht.analysis(torch.from_numpy(maps), theta, lmax, w, spin=(0, 2))
	a = curvedsky.almxfl(a, fl, ainfo=curvedsky.alm_info(lmax=lmax))
	out = sht.synthesis(a, theta, nphi, lmax=lmax, spin=(0, 2))
	close(a, ja)
	close(out, jout)
