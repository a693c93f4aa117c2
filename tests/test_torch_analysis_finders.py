"""pixell_tpu_torch.analysis's finders, measurers and modellers against
pixell_tpu.analysis on the CPU in flat mode (float64, inputs from a numpy
seed): four sources of flux 12-40 in white noise on a 4 x 4 degree CAR
patch at 0.02 degrees, a 14 arcmin beam and a three times wider second
profile. FinderSimple, FinderIterative over ModellerPerpix, FinderMulti,
FinderMultiSafe (its circles a labeled distance transform, K13's plain
version), MeasurerSimple, MeasurerMulti, MeasurerIterative,
ModellerPerfreq, ModellerScaled, ModellerMulti and make_circle_labels:
each catalogue field, map and amplitude within 1e-10 of its largest value.
The reference's flood runs with jax.disable_jit() (see
test_torch_distances.py).
"""
import jax
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


def same_cat(got, want, fields=None):
	assert len(got) == len(want) and len(want) > 0
	for f in fields or want.dtype.names:
		assert rel(np.asarray(got[f], float), np.asarray(want[f], float)) <= TOL, f


@pytest.fixture(scope="module")
def scene():
	shape, wcs = jenmap.geometry(pos=np.array([[-2, 2], [2, -2]])*jutils.degree, res=0.02*jutils.degree, proj="car")
	sigma = 1.4*jutils.fwhm*jutils.arcmin*10
	r = np.linspace(0, 8*sigma, 2000)
	b1 = np.exp(-0.5*(r/sigma)**2)/(2*np.pi*sigma**2)
	b2 = np.exp(-0.5*(r/(3*sigma))**2)/(2*np.pi*(3*sigma)**2)
	poss = np.array([[0.0, 0.016, -0.018, 0.012], [0.0, -0.02, 0.015, 0.017]])
	flux = np.array([40.0, 25.0, 15.0, 12.0])
	m = np.asarray(jpointsrcs.sim_objects(shape, wcs, poss, flux, np.array([r, b1]), dtype=np.float64))
	rng = np.random.default_rng(5)
	total = m + rng.standard_normal(shape)*0.5/np.sqrt(jenmap.pixsize(shape, wcs))
	juht = juharm.UHT(shape, wcs, mode="flat")
	tuht = uharm.UHT(shape, wcs, mode="flat", device="cpu")
	iN = np.ones(shape)/0.25
	s = dict(shape=shape, wcs=wcs, r=r, b1=b1, b2=b2, poss=poss, flux=flux, juht=juht, tuht=tuht,
		jmap=jenmap.ndmap(total, wcs), tmap=enmap.ndmap(torch.from_numpy(total), wcs))
	s["jn"] = [janalysis.NmatConstcov(iN, np.asarray(juht.rprof2hprof(b, r)), juht) for b in (b1, b2)]
	s["tn"] = [analysis.NmatConstcov(torch.from_numpy(iN), tuht.rprof2hprof(b, r), tuht) for b in (b1, b2)]
	return s


def test_finder_simple(scene):
	s = scene
	want = janalysis.FinderSimple(s["jn"][0], snmin=10)(s["jmap"])
	got = analysis.FinderSimple(s["tn"][0], snmin=10)(s["tmap"])
	same_cat(got.cat, want.cat)
	assert len(want.cat) == 4
	assert rel(got.snr, want.snr) <= TOL and rel(got.flux, want.flux) <= TOL


def test_finder_iterative(scene):
	s = scene
	jprof, tprof = np.array([s["r"], s["b1"]]), np.array([s["r"], s["b1"]])
	want = janalysis.FinderIterative(janalysis.FinderSimple(s["jn"][0], snmin=10),
		janalysis.ModellerPerpix(s["shape"], s["wcs"], jprof), niter=2)(s["jmap"])
	got = analysis.FinderIterative(analysis.FinderSimple(s["tn"][0], snmin=10),
		analysis.ModellerPerpix(s["shape"], s["wcs"], tprof, device="cpu"), niter=2)(s["tmap"])
	same_cat(got.cat, want.cat)
	assert rel(got.resid, want.resid) <= TOL and rel(got.model, want.model) <= TOL


def test_finder_multi(scene):
	s = scene
	want = janalysis.FinderMulti(s["jn"], snmin=10)(s["jmap"])
	got = analysis.FinderMulti(s["tn"], snmin=10)(s["tmap"])
	same_cat(got.cat, want.cat)
	assert rel(got.snr, want.snr) <= TOL


def test_finder_multi_safe(scene):
	s = scene
	with jax.disable_jit():
		want = janalysis.FinderMultiSafe(s["jn"], snmin=10, r=5*jutils.arcmin)(s["jmap"])
	got = analysis.FinderMultiSafe(s["tn"], snmin=10, r=5*jutils.arcmin)(s["tmap"])
	same_cat(got.cat, want.cat)
	assert rel(got.snr, want.snr) <= TOL and got.snmin == want.snmin
	assert set(analysis.HOST_MS) == set(analysis.HOST_STAGES)
	empty = analysis.FinderMultiSafe(s["tn"], snmin=1e9)(s["tmap"])
	assert len(empty.cat) == 0


def test_make_circle_labels(scene):
	s = scene
	pixs = np.array([[50, 100, 150], [60, 120, 30]])
	with jax.disable_jit():
		want = janalysis.make_circle_labels(s["shape"], s["wcs"], pixs, inds=np.array([3, 1, 2]), r=0.1)
	got = analysis.make_circle_labels(s["shape"], s["wcs"], pixs, inds=np.array([3, 1, 2]), r=0.1, device="cpu")
	assert got.dtype == torch.int32 and np.array_equal(got.data.numpy(), np.asarray(want))


def measure_cat(s):
	cat = np.zeros(4, [("dec", "f8"), ("ra", "f8"), ("flux", "f8"), ("dflux", "f8"), ("snr", "f8"), ("case", "i4")])
	cat["dec"], cat["ra"], cat["snr"], cat["case"] = s["poss"][0], s["poss"][1], [80, 50, 30, 24], [0, 1, 0, 1]
	return cat


def test_measurers(scene):
	s = scene
	cat = measure_cat(s)
	same_cat(analysis.MeasurerSimple(s["tn"][0])(s["tmap"], cat).cat,
		janalysis.MeasurerSimple(s["jn"][0])(s["jmap"], cat).cat)
	same_cat(analysis.MeasurerMulti([analysis.MeasurerSimple(n) for n in s["tn"]])(s["tmap"], cat).cat,
		janalysis.MeasurerMulti([janalysis.MeasurerSimple(n) for n in s["jn"]])(s["jmap"], cat).cat)
	prof = np.array([s["r"], s["b1"]])
	got = analysis.MeasurerIterative(analysis.MeasurerSimple(s["tn"][0]),
		analysis.ModellerPerpix(s["shape"], s["wcs"], prof, device="cpu"), sntol=0.5)(s["tmap"], cat)
	want = janalysis.MeasurerIterative(janalysis.MeasurerSimple(s["jn"][0]),
		janalysis.ModellerPerpix(s["shape"], s["wcs"], prof), sntol=0.5)(s["jmap"], cat)
	same_cat(got.cat, want.cat)
	assert rel(got.model, want.model) <= TOL


def test_modellers(scene):
	s = scene
	cat = measure_cat(s)
	cat2 = np.zeros(4, [("dec", "f8"), ("ra", "f8"), ("flux", "f8", (2,)), ("case", "i4")])
	cat2["dec"], cat2["ra"], cat2["case"] = cat["dec"], cat["ra"], cat["case"]
	cat2["flux"] = np.array([[1e-6, 2e-6], [3e-6, 1e-6], [2e-6, 2e-6], [1e-6, 5e-7]])
	profs = [(s["r"], s["b1"]), (s["r"], s["b2"])]
	cat["flux"] = [1e-6, 2e-6, 3e-6, 4e-6]
	pairs = [(analysis.ModellerPerfreq(s["shape"], s["wcs"], profs, dtype=np.float64, device="cpu"),
			janalysis.ModellerPerfreq(s["shape"], s["wcs"], profs, dtype=np.float64), cat2),
		(analysis.ModellerScaled(s["shape"], s["wcs"], profs, [1.0, 0.5], dtype=np.float64, device="cpu"),
			janalysis.ModellerScaled(s["shape"], s["wcs"], profs, [1.0, 0.5], dtype=np.float64), cat)]
	for port, ref, c in pairs:
		assert rel(port(c), ref(c)) <= TOL
		assert rel(port.amplitudes(c), ref.amplitudes(c)) <= TOL
		assert rel(port(c[:0]), ref(c[:0])) == 0
	mp = [analysis.ModellerPerpix(s["shape"], s["wcs"], np.array(p), dtype=np.float64, device="cpu") for p in profs]
	jp = [janalysis.ModellerPerpix(s["shape"], s["wcs"], np.array(p), dtype=np.float64) for p in profs]
	assert rel(analysis.ModellerMulti(mp)(cat), janalysis.ModellerMulti(jp)(cat)) <= TOL
	ms = [analysis.ModellerPerfreq(s["shape"], s["wcs"], [p], dtype=np.float64, device="cpu") for p in profs]
	js = [janalysis.ModellerPerfreq(s["shape"], s["wcs"], [p], dtype=np.float64) for p in profs]
	assert rel(analysis.ModellerMulti(ms).amplitudes(cat), janalysis.ModellerMulti(js).amplitudes(cat)) <= TOL
