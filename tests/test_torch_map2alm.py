"""map2alm on "cyl" geometries and with explicit weights (against
pixell_tpu.curvedsky.map2alm on the same numpy maps), and the host-built
tables of the transforms, which are cached per shape, dtype and device so
that a repeated transform makes no host -> device copy. Every port call asks
for the CPU.

Tolerance: 1e-10 of the largest reference value in float64 (same
algorithms, other summation order and FFT library). The cached tables must
be bit-identical to the uncached expressions they replace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import enmap, curvedsky, sht, wcsutils

LMAX = 12
SHAPE = (20, 40)
BAND = (14, 40)   # rows of a grid shifted off every quadrature grid


def geometries():
	"""(reference wcs, port wcs) of the full-sky Fejer-1 grid and of the same
	grid moved by 0.3 rows, whose rings are no CC/F1 grid: a "cyl"
	geometry."""
	_, jwcs = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	jcyl = jwcs.deepcopy()
	jcyl.wcs.crpix = np.array(jwcs.wcs.crpix) + [0, 0.3]
	port = lambda w: wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)
	return (jwcs, port(jwcs)), (jcyl, port(jcyl))


def rel(got, want):
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got.numpy() - want).max()/np.abs(want).max()


@pytest.mark.parametrize("spin,pre", [([0], ()), ([0, 2], (3,))])
def test_map2alm_cyl(spin, pre):
	"""A band of a cyl geometry: ring-edge quadrature on the map's rings,
	and one Jacobi iteration through alm2map on the same geometry."""
	_, (jcyl, cyl) = geometries()
	assert jcurvedsky.analyse_geometry(BAND, jcyl).case == "cyl"
	assert curvedsky.analyse_geometry(BAND, cyl).case == "cyl"
	m = np.random.default_rng(1).standard_normal(pre + BAND)
	for niter in (0, 1):
		want = jcurvedsky.map2alm(jenmap.ndmap(m, jcyl), lmax=LMAX, spin=spin, niter=niter)
		got = curvedsky.map2alm(enmap.ndmap(torch.from_numpy(m), cyl), lmax=LMAX, spin=spin,
			niter=niter)
		assert got.dtype == torch.complex128
		assert rel(got, want) <= 1e-10, niter


def test_map2alm_weights():
	"""Explicit per-row weights on a 2d map whose rows are flipped (dec
	ascending): quadrature with them, flipped to the ring order, on the map's
	own rings instead of the 2d path."""
	(jwcs, wcs), _ = geometries()
	assert curvedsky.analyse_geometry(SHAPE, wcs).flip[0]
	rng = np.random.default_rng(2)
	m = rng.standard_normal((3,) + SHAPE)
	w = rng.uniform(0.5, 1.5, SHAPE[0])
	want = jcurvedsky.map2alm(jenmap.ndmap(m, jwcs), lmax=LMAX, spin=[0, 2], weights=w)
	got = curvedsky.map2alm(enmap.ndmap(torch.from_numpy(m), wcs), lmax=LMAX, spin=[0, 2],
		weights=w)
	assert rel(got, want) <= 1e-10
	# the 2d path is taken by the geometry's case, whatever the method says
	tm = enmap.ndmap(torch.from_numpy(m), wcs)
	assert torch.equal(curvedsky.map2alm(tm, lmax=LMAX, spin=[0, 2], method="cyl"),
		curvedsky.map2alm(tm, lmax=LMAX, spin=[0, 2]))


def test_map2alm_allocates_no_alm(monkeypatch):
	"""Without alm, map2alm returns its result and allocates none to throw
	away; with alm it writes into it."""
	(_, wcs), _ = geometries()
	tm = enmap.ndmap(torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE)), wcs)
	want = curvedsky.map2alm(tm, lmax=LMAX, spin=[0])
	def refuse(*args, **kw): raise AssertionError("prepare_alm called")
	monkeypatch.setattr(curvedsky, "prepare_alm", refuse)
	assert torch.equal(curvedsky.map2alm(tm, lmax=LMAX, spin=[0]), want)
	out = torch.zeros_like(want)
	assert curvedsky.map2alm(tm, alm=out, spin=[0]) is out and torch.equal(out, want)


def _resample_uncached(F, variant, nt_out, spins, m0):
	"""_resample_theta_phase as it was before its tables were cached."""
	nm, nt = F.shape[-2:]
	rdt = F.real.dtype
	m = np.arange(m0, m0 + nm)
	sgn_m = torch.as_tensor(np.where(m % 2 == 0, 1.0, -1.0), dtype=rdt, device=F.device)[:, None]
	sgn_s = torch.as_tensor([(-1.0)**s for s in spins], dtype=rdt, device=F.device)[:, None, None]
	if variant in ["F1", "FEJER1"]:
		mirror = F.flip(-1)*sgn_m*sgn_s
		NT_in, NT_out = 2*nt, 2*nt_out
	else:
		mirror = F[..., 1:-1].flip(-1)*sgn_m*sgn_s
		NT_in, NT_out = 2*(nt-1), 2*(nt_out-1)
	ft = torch.fft.fft(torch.cat([F, mirror], -1), dim=-1)
	if variant in ["F1", "FEJER1"]:
		ft = ft*torch.from_numpy(np.exp(-1j*np.pi*np.fft.fftfreq(NT_in))).to(ft.device, ft.dtype)
	ft = sht.enfft.resample(ft, NT_out, axes=(-1,))/NT_in*NT_out
	if variant in ["F1", "FEJER1"]:
		ft = ft*torch.from_numpy(np.exp(1j*np.pi*np.fft.fftfreq(NT_out))).to(ft.device, ft.dtype)
	return torch.fft.ifft(ft, dim=-1)[..., :nt_out]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_tables_cached(dtype):
	"""The phase ramp, the quadrature weights and the resample factors are
	built and copied to the device once per arguments: a repeated map2alm
	(F1, phi0 != 0, theta-upsampled) builds none of them again, leaves them
	unchanged and gives the same alm; each is bit-identical to the
	expression it replaces."""
	(_, wcs), _ = geometries()
	m = torch.from_numpy(np.random.default_rng(4).standard_normal((3,) + SHAPE)).to(dtype)
	tm = enmap.ndmap(m, wcs)
	caches = [sht._phase_ramp_cached, sht._ring_weights_cached, sht._resample_tables]
	first = curvedsky.map2alm(tm, lmax=LMAX, spin=[0, 2])
	misses = [c.cache_info().misses for c in caches]
	hits = [c.cache_info().hits for c in caches]
	cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
	minfo = curvedsky.analyse_geometry(SHAPE, wcs)
	assert minfo.phi0 != 0
	nphi, nt_up = minfo.nphi, curvedsky.enfft.fft_len(2*LMAX + 3, direction="above")
	w = sht.ring_weights("F1", nt_up)
	tables = [sht._phase_ramp(LMAX + 1, minfo.phi0, cdt, -1, "cpu"),
		sht._ring_weights_on(w, nphi, dtype, "cpu"),
		*sht._resample_tables(0, LMAX + 1, (0, 2, 2), dtype, cdt, 2*SHAPE[0], 2*nt_up,
			torch.device("cpu"))]
	saved = [t.clone() for t in tables]
	again = curvedsky.map2alm(tm, lmax=LMAX, spin=[0, 2])
	assert [c.cache_info().misses for c in caches] == misses
	assert all(c.cache_info().hits > h for c, h in zip(caches, hits))
	assert torch.equal(again, first)
	assert all(torch.equal(t, s) for t, s in zip(tables, saved))
	assert tables[0] is sht._phase_ramp(LMAX + 1, minfo.phi0, cdt, -1, torch.device("cpu"))
	# bit-identical to the uncached expressions
	ph = -np.arange(LMAX + 1)*float(minfo.phi0)
	assert torch.equal(tables[0], torch.from_numpy(np.cos(ph) + 1j*np.sin(ph)).to(dtype=cdt))
	assert torch.equal(tables[1], torch.as_tensor(np.asarray(w)*(2*np.pi/nphi), dtype=dtype))
	F = torch.from_numpy(np.random.default_rng(5).standard_normal((3, LMAX + 1, SHAPE[0], 2))
		).to(dtype).contiguous()
	F = torch.complex(F[..., 0], F[..., 1])
	for variant, nt in (("F1", SHAPE[0]), ("CC", SHAPE[0] + 1)):
		Fv = F if variant == "F1" else torch.cat([F, F[..., :1]], -1)
		assert torch.equal(sht.resample_theta_phase(Fv, variant, 2*nt + 3, (0, 2, 2)),
			_resample_uncached(Fv, variant, 2*nt + 3, (0, 2, 2), 0))
