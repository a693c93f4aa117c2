"""pixell_tpu_torch.analysis in curved mode against pixell_tpu.analysis on
the CPU (float64, inputs from a numpy seed; the SHTs through the Legendre
kernels' plain versions): the matched filters (constcov, white,
constcorr_lowcorr, constcorr_smoothivar, constcorr_dual) on a 34 x 68
Fejer-1 full-sky map at lmax 32 with 8-degree beams, within 1e-10 of the
largest value; the noise models' simulate in curved mode (the reference's
names curvedsky, which it does not import, and raises NameError: asserted,
and the port held to the reference's own hrand and alm2map). NmatWavelet
is in test_torch_analysis_wavelet.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import analysis as janalysis, enmap as jenmap, uharm as juharm, curvedsky as jcurvedsky, \
	wavelets as jwavelets, utils as jutils
from pixell_tpu_torch import analysis, enmap, uharm, wavelets

TOL = 1e-10
LMAX = 32


def rel(got, want):
	got = got.data if isinstance(got, enmap.ndmap) else got
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
	return float(np.max(np.abs(got - want))/max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def scene():
	shape, wcs = jenmap.fullsky_geometry(shape=(34, 68), variant="fejer1")
	rng = np.random.default_rng(7)
	m = rng.standard_normal(shape)
	juht = juharm.UHT(shape, wcs, mode="curved", lmax=LMAX)
	tuht = uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, device="cpu")
	r = np.linspace(0, np.pi, 2000)
	br = np.exp(-0.5*(r/(8*jutils.degree))**2)
	jB, tB = np.asarray(juht.rprof2hprof(br, r)), tuht.rprof2hprof(br, r)
	y = np.arange(shape[0])[:, None] + np.zeros(shape)
	ivar = 1 + 0.5*np.cos(np.pi*y/shape[0])
	l = np.arange(LMAX + 1)
	iC = 1/(1 + (np.maximum(l, 1)/10.)**-2)
	return dict(shape=shape, wcs=wcs, m=m, juht=juht, tuht=tuht, jB=jB, tB=tB, ivar=ivar, iC=iC,
		jmap=jenmap.ndmap(m, wcs), tmap=enmap.ndmap(torch.from_numpy(m), wcs))


@pytest.mark.parametrize("name", ["constcov", "white", "lowcorr", "smoothivar", "dual"])
def test_matched_filters_curved(scene, name):
	s = scene
	iN = np.ones(LMAX + 1)/0.5
	args = {"constcov": lambda mod, m, B, u, iv: mod.matched_filter_constcov(m, B, iN, uht=u),
		"white": lambda mod, m, B, u, iv: mod.matched_filter_white(m, B, iv, uht=u),
		"lowcorr": lambda mod, m, B, u, iv: mod.matched_filter_constcorr_lowcorr(m, B, iv, s["iC"], uht=u),
		"smoothivar": lambda mod, m, B, u, iv: mod.matched_filter_constcorr_smoothivar(m, B, iv, s["iC"], uht=u),
		"dual": lambda mod, m, B, u, iv: mod.matched_filter_constcorr_dual(m, B, iv, s["iC"], uht=u)}[name]
	jr, jk = args(janalysis, s["jmap"], s["jB"], s["juht"], s["ivar"])
	tr, tk = args(analysis, s["tmap"], s["tB"], s["tuht"], torch.from_numpy(s["ivar"]))
	assert rel(tr, jr) <= TOL and rel(tk, jk) <= TOL


def test_simulate_curved(scene):
	s = scene
	iN = np.linspace(1, 2, LMAX + 1)
	with pytest.raises(NameError):
		janalysis.NmatConstcov(iN, s["jB"], s["juht"]).simulate(seed=3)
	want = jcurvedsky.alm2map(s["juht"].hrand(1/iN, seed=3), jenmap.zeros(s["shape"], s["wcs"]))
	got = analysis.NmatConstcov(iN, s["tB"], s["tuht"]).simulate(seed=3)
	assert rel(got, want) <= TOL
	ivar = enmap.ndmap(torch.from_numpy(s["ivar"]), s["wcs"])
	got = analysis.NmatConstcorr(iN, ivar, s["tB"], s["tuht"]).simulate(seed=3)
	assert rel(got, np.asarray(want)*s["ivar"]**-0.5) <= TOL
