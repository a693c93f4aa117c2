"""pixell_tpu_torch.analysis.NmatWavelet against pixell_tpu's on the CPU
(float64, inputs from a numpy seed): over a ButterTrim wavelet transform of
the curved UHT of test_torch_analysis_curved.py's 34 x 68 Fejer-1 map at
lmax 32, calibrate's per-scale variances, apply_iN and matched_filter
without and with an 8-degree beam, within 1e-10 of the largest value.
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


def test_nmat_wavelet(scene):
	s = scene
	jwt = jwavelets.WaveletTransform(s["juht"], basis=jwavelets.ButterTrim(step=2))
	twt = wavelets.WaveletTransform(s["tuht"], basis=wavelets.ButterTrim(step=2), device="cpu")
	noise = np.random.default_rng(8).standard_normal(s["shape"])
	jn = janalysis.NmatWavelet(jwt, noise_map=jenmap.ndmap(noise, s["wcs"]), smooth_pix=3)
	tn = analysis.NmatWavelet(twt, noise_map=enmap.ndmap(torch.from_numpy(noise), s["wcs"]), smooth_pix=3)
	assert len(tn.vars) == len(jn.vars)
	for a, b in zip(tn.vars, jn.vars): assert rel(a, b) <= TOL
	assert rel(tn.apply_iN(s["tmap"]), jn.apply_iN(s["jmap"])) <= TOL
	for got, want in zip(tn.matched_filter(s["tmap"]), jn.matched_filter(s["jmap"])):
		assert rel(got, want) <= TOL
	jn.B, tn.B = s["jB"], s["tB"]
	for got, want in zip(tn.matched_filter(s["tmap"]), jn.matched_filter(s["jmap"])):
		assert rel(got, want) <= TOL
