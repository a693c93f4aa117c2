"""pixell_tpu_torch.analysis's matched filters and helpers against
pixell_tpu.analysis on the CPU in flat mode (float64, inputs from a numpy
seed; the scene of the reference's module docstring: a 10-flux source in
white noise on a 4 x 4 degree CAR patch at 0.02 degrees):

- matched_filter_constcov, _white, _constcorr_lowcorr,
  _constcorr_smoothivar and _constcorr_dual (rho and kappa), and
  solve_mapsys, within 1e-10 of the largest value;
- the regression values of the reference's docstring (constcov flux
  10.046, dflux 0.003, snr 3260.3; white flux 10.048, snr 3260.7);
- snr_split, sanitize_kappa (flat and with a component diagonal),
  safe_pow, get_flat_sky_correction, dtype_concat, merge_arrays, get_ref,
  rpow / rmul / rop, get_central_radius;
- the noise models' simulate in flat mode (the same numpy draws);
- every public name of the reference module exists in the port, and the
  shared functions take the reference's parameters in order.

The finders, measurers and modellers are in test_torch_analysis_finders.py,
curved mode and NmatWavelet in test_torch_analysis_curved.py.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import analysis as janalysis, enmap as jenmap, uharm as juharm, pointsrcs as jpointsrcs, \
	utils as jutils
from pixell_tpu_torch import analysis, enmap, uharm

TOL = 1e-10


def rel(got, want):
	got = got.data if isinstance(got, enmap.ndmap) else got
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
	return float(np.max(np.abs(got - want))/max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def scene():
	shape, wcs = jenmap.geometry(pos=np.array([[-2, 2], [2, -2]])*jutils.degree, res=0.02*jutils.degree, proj="car")
	sigma = 1.4*jutils.fwhm*jutils.arcmin*10
	r = np.linspace(0, 8*sigma, 2000)
	prof = np.array([r, np.exp(-0.5*(r/sigma)**2)/(2*np.pi*sigma**2)])
	m = np.asarray(jpointsrcs.sim_objects(shape, wcs, np.array([[0.0], [0.0]]), np.array([10.0]), prof,
		dtype=np.float64))
	noise = 0.5
	rng = np.random.default_rng(1)
	total = m + rng.standard_normal(shape)*noise/np.sqrt(jenmap.pixsize(shape, wcs))
	juht = juharm.UHT(shape, wcs, mode="flat")
	tuht = uharm.UHT(shape, wcs, mode="flat", device="cpu")
	jB = np.asarray(juht.rprof2hprof(prof[1], prof[0]))
	tB = tuht.rprof2hprof(prof[1], prof[0])
	l = np.asarray(jenmap.modlmap(shape, wcs))
	iC = 1/(1 + (np.maximum(l, 1)/300.)**-2)
	y, x = np.mgrid[:shape[0], :shape[1]]
	ivar = (1 + 0.3*np.cos(2*np.pi*x/shape[1])*np.sin(np.pi*y/shape[0]))/(noise**2/jenmap.pixsize(shape, wcs))
	return dict(shape=shape, wcs=wcs, prof=prof, total=total, noise=noise, juht=juht, tuht=tuht, jB=jB, tB=tB,
		iC=iC, ivar=ivar, jmap=jenmap.ndmap(total, wcs), tmap=enmap.ndmap(torch.from_numpy(total), wcs))


def call(name, s, port):
	"""The filter name on the scene: the port's on tensors, the reference's
	on numpy."""
	mod = analysis if port else janalysis
	m, uht, B = (s["tmap"], s["tuht"], s["tB"]) if port else (s["jmap"], s["juht"], s["jB"])
	ivar = torch.from_numpy(s["ivar"]) if port else s["ivar"]
	iC = torch.from_numpy(s["iC"]) if port else s["iC"]
	iN = torch.ones(tuple(s["shape"]), dtype=torch.float64)/s["noise"]**2 if port else \
		np.ones(s["shape"])/s["noise"]**2
	if name == "constcov": return mod.matched_filter_constcov(m, B, iN, uht=uht)
	if name == "white": return mod.matched_filter_white(m, B, ivar, uht=uht)
	if name == "lowcorr": return mod.matched_filter_constcorr_lowcorr(m, B, ivar, iC, uht=uht)
	if name == "smoothivar": return mod.matched_filter_constcorr_smoothivar(m, B, ivar, iC, uht=uht)
	return mod.matched_filter_constcorr_dual(m, B, ivar, iC, uht=uht)


@pytest.mark.parametrize("name", ["constcov", "white", "lowcorr", "smoothivar", "dual"])
def test_matched_filters(scene, name):
	(jr, jk), (tr, tk) = call(name, scene, False), call(name, scene, True)
	assert rel(tr, jr) <= TOL
	assert rel(tk, jk) <= TOL
	for got, want in zip(analysis.solve_mapsys(tk, tr), janalysis.solve_mapsys(jk, jr)):
		assert rel(got, want) <= TOL


def test_docstring_regression(scene):
	"""The numbers in the reference's module docstring."""
	cy, cx = scene["shape"][0]//2, scene["shape"][1]//2
	flux, dflux, snr = analysis.solve_mapsys(*call("constcov", scene, True)[::-1])
	assert (round(float(flux[cy, cx]), 3), round(float(dflux), 3), round(float(snr[cy, cx]), 1)) == \
		(10.046, 0.003, 3260.3)
	ivar = torch.full(tuple(scene["shape"]), jenmap.pixsize(scene["shape"], scene["wcs"])/scene["noise"]**2,
		dtype=torch.float64)   # the docstring's white noise
	tr, tk = analysis.matched_filter_white(scene["tmap"], scene["tB"], ivar, uht=scene["tuht"])
	flux, dflux, snr = analysis.solve_mapsys(tk, tr)
	assert (round(float(flux[cy, cx]), 3), round(float(snr[cy, cx]), 1)) == (10.048, 3260.7)


def test_helpers(scene):
	snrs = [100, 90, 20, 6, 3, 2, 40]
	got = analysis.snr_split(snrs, sntol=0.25, snmin=5)
	want = janalysis.snr_split(snrs, sntol=0.25, snmin=5)
	assert [list(map(int, g)) for g in got] == [list(map(int, g)) for g in want]
	k = np.array([2.0, 1e-9, 1.0])
	assert rel(analysis.sanitize_kappa(k), janalysis.sanitize_kappa(k)) == 0
	k4 = np.random.default_rng(2).uniform(1e-9, 1, (2, 2, 5, 6))
	k4[0, 0, 0, 0] = 1e-12
	assert rel(analysis.sanitize_kappa(torch.from_numpy(k4), tol=1e-3), janalysis.sanitize_kappa(k4, tol=1e-3)) == 0
	km = enmap.ndmap(torch.from_numpy(k4[0, 0]), scene["wcs"])
	assert isinstance(analysis.sanitize_kappa(km), enmap.ndmap)
	x = np.array([-4.0, 0.0, 9.0])
	assert rel(analysis.safe_pow(x, 0.5), janalysis.safe_pow(x, 0.5)) == 0
	x = np.array([-4.0, 0.5, 9.0])
	assert rel(analysis.safe_pow(torch.from_numpy(x), -1.5), janalysis.safe_pow(x, -1.5)) <= TOL
	assert analysis.get_flat_sky_correction(1.3) == janalysis.get_flat_sky_correction(1.3)
	a = np.zeros(3, [("a", "f8"), ("b", "i4")]); b = np.ones(3, [("c", "f4")])
	assert analysis.dtype_concat([a.dtype, b.dtype]) == janalysis.dtype_concat([a.dtype, b.dtype])
	assert np.array_equal(analysis.merge_arrays([a, b]), janalysis.merge_arrays([a, b]))
	v = np.abs(np.random.default_rng(3).standard_normal(5000))
	assert analysis.get_ref(torch.from_numpy(v)) == janalysis.get_ref(v)
	assert analysis.get_ref(-v) == janalysis.get_ref(-v) == 0


def test_real_space_ops(scene):
	wcs, shape = scene["wcs"], scene["shape"]
	l = np.asarray(jenmap.modlmap(shape, wcs))
	F = np.exp(-0.5*(l/2000.)**2)
	jF, tF = jenmap.ndmap(F, wcs), enmap.ndmap(torch.from_numpy(F), wcs)
	assert rel(analysis.rpow(tF, 2), janalysis.rpow(jF, 2)) <= TOL
	assert rel(analysis.rmul(tF, tF), janalysis.rmul(jF, jF)) <= TOL
	assert rel(analysis.rop(tF, tF, op=torch.add), janalysis.rop(jF, jF, op=np.add)) <= TOL
	assert analysis.get_central_radius(scene["tB"]) == pytest.approx(
		janalysis.get_central_radius(jenmap.ndmap(scene["jB"], wcs)), rel=1e-12)


def test_simulate(scene):
	s = scene
	iN = np.ones(s["shape"])/s["noise"]**2
	cases = [(analysis.NmatWhite(torch.from_numpy(s["ivar"]), s["tB"], s["tuht"]),
			janalysis.NmatWhite(jenmap.ndmap(s["ivar"], s["wcs"]), s["jB"], s["juht"])),
		(analysis.NmatConstcov(torch.from_numpy(iN), s["tB"], s["tuht"]), janalysis.NmatConstcov(iN, s["jB"], s["juht"])),
		(analysis.NmatConstcorr(torch.from_numpy(s["iC"]), enmap.ndmap(torch.from_numpy(s["ivar"]), s["wcs"]), s["tB"],
			s["tuht"]), janalysis.NmatConstcorr(s["iC"], jenmap.ndmap(s["ivar"], s["wcs"]), s["jB"], s["juht"]))]
	for port, ref in cases:
		assert rel(port.sim(seed=4), ref.sim(seed=4)) <= TOL


def test_public_names():
	names = [n for n in dir(janalysis) if not n.startswith("_") and n not in ("np", "jnp", "annotations")]
	missing = [n for n in names if not hasattr(analysis, n)]
	assert not missing
	for n in names:
		r, p = getattr(janalysis, n), getattr(analysis, n)
		if inspect.isfunction(r) and inspect.getmodule(r) is janalysis:
			rp = list(inspect.signature(r).parameters)
			assert list(inspect.signature(p).parameters)[:len(rp)] == rp, n
