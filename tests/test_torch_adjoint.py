"""The adjoint transforms of pixell_tpu_torch.curvedsky (alm2map_adjoint,
alm2map(adjoint=True), map2alm_adjoint, map2alm(adjoint=True)) and the
transposed theta resample under them, in float64 on the CPU, with inputs
made from a numpy seed:

- the dot-product identities <map2alm(m), a> = <m, map2alm_adjoint(a)> and
  <alm2map(a), m> = <a, alm2map_adjoint(m)> within 1e-10 relative, on a
  full-sky Fejer-1 grid that forces the theta upsample (20x40 at lmax 12),
  a Clenshaw-Curtis grid, a band with y padding, a "cyl" geometry and with
  deriv; the alm inner product is sum Re(x) Re(y) + Im(x) Im(y) over the
  stored entries, the reference's vjp convention;
- the same identity for the transposed resample alone, Clenshaw-Curtis and
  Fejer-1, odd and even ring counts, up and down, in m chunks that start
  at m0 > 0;
- the four entries against pixell_tpu.curvedsky's map2alm_adjoint (its
  jax.vjp) and alm2map_adjoint for spin 0, IQU and spin [0, 3] on the
  Fejer-1 grid, within 1e-10 of the largest reference value
  (tests/test_torch_adjoint_geometries.py does the other geometries).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import enmap, curvedsky, sht, wcsutils
from pixell_tpu_torch.ops import sht_cuda

LMAX = 12
SHAPE = (20, 40)
SPINS = {"spin0": ([0], None), "IQU": ([0, 2], 3), "spin03": ([0, 3], 3)}


def port_wcs(w):
	return wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)


def geometry(name):
	"""(shape, reference wcs, port wcs) of a test geometry."""
	if name == "CC":
		shape, jwcs = jenmap.fullsky_geometry(shape=(SHAPE[0] + 1, SHAPE[1]), variant="cc")
		return shape, jwcs, port_wcs(jwcs)
	shape, jwcs = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	if name == "band":   # rows 4..14: y padding on both sides
		shape, jwcs = jenmap.slice_geometry(shape, jwcs, (slice(4, 15), slice(None)))
	elif name == "cyl":  # rows moved off every quadrature grid
		jwcs = jwcs.deepcopy()
		jwcs.wcs.crpix = np.array(jwcs.wcs.crpix) + [0, 0.3]
	return shape, jwcs, port_wcs(jwcs)


def inputs(shape, spin, ncomp, deriv, seed):
	"""(map, alm) as float64 / complex128 numpy arrays for the geometry and
	spin: deriv takes a [2, ny, nx] map and one alm."""
	rng = np.random.default_rng(seed)
	nalm = curvedsky.alm_info(lmax=LMAX).nelem
	if deriv: mshape, ashape = (2,) + shape, (nalm,)
	elif ncomp is None: mshape, ashape = shape, (nalm,)
	else: mshape, ashape = (ncomp,) + shape, (ncomp, nalm)
	return rng.standard_normal(mshape), rng.standard_normal(ashape) + 1j*rng.standard_normal(ashape)


def dot(x, y):
	x, y = torch.as_tensor(x), torch.as_tensor(y)
	if x.is_complex(): return float((x.real*y.real + x.imag*y.imag).sum())
	return float((x*y).sum())


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def cpu_map(arr, wcs):
	return enmap.ndmap(torch.from_numpy(np.array(arr)), wcs)


CASES = [("F1", "spin0", False), ("F1", "IQU", False), ("F1", "spin03", False),
	("F1", "spin0", True), ("CC", "IQU", False), ("band", "IQU", False), ("band", "spin0", True),
	("cyl", "IQU", False), ("cyl", "spin0", True)]


@pytest.mark.parametrize("geom,spins,deriv", CASES)
def test_dot_product_identities(geom, spins, deriv):
	shape, _, wcs = geometry(geom)
	spin, ncomp = SPINS[spins]
	m, a = inputs(shape, spin, ncomp, deriv, seed=len(geom) + 3*deriv)
	tm, ta = cpu_map(m, wcs), torch.from_numpy(a)
	ainfo = curvedsky.alm_info(lmax=LMAX)
	# map2alm and its adjoint
	fwd = curvedsky.map2alm(tm, lmax=LMAX, spin=spin, deriv=deriv)
	back = curvedsky.map2alm_adjoint(ta, enmap.zeros(m.shape, wcs, device="cpu"), spin=spin,
		deriv=deriv)
	lhs, rhs = dot(fwd, ta), dot(tm.data, back.data)
	assert abs(lhs - rhs) <= 1e-10*abs(lhs)
	# alm2map and its adjoint
	fwd = curvedsky.alm2map(ta, enmap.zeros(m.shape, wcs, device="cpu"), spin=spin, deriv=deriv)
	back = curvedsky.alm2map_adjoint(tm, spin=spin, deriv=deriv, ainfo=ainfo)
	lhs, rhs = dot(fwd.data, tm.data), dot(ta, back)
	assert abs(lhs - rhs) <= 1e-10*abs(lhs)


@pytest.mark.parametrize("variant", ["CC", "F1"])
@pytest.mark.parametrize("nt,nt_out", [(10, 25), (11, 24), (20, 15), (21, 14)])
def test_resample_adjoint(variant, nt, nt_out, monkeypatch):
	"""Re<resample(F), G> = Re<F, resample_adjoint(G)>, in m chunks of 3
	(7 m rows: chunks at m0 = 0, 3, 6)."""
	monkeypatch.setattr(sht, "MCHUNK_RESAMPLE", 3)
	rng = np.random.default_rng(nt)
	c = lambda *s: torch.from_numpy(rng.standard_normal(s) + 1j*rng.standard_normal(s))
	F, G = c(3, 7, nt), c(3, 7, nt_out)
	spins = [0, 2, 2]
	fwd = sht.resample_theta_phase(F, variant, nt_out, spins)
	back = sht.resample_theta_phase_adjoint(G, variant, nt, spins)
	assert tuple(back.shape) == tuple(F.shape)
	lhs, rhs = dot(fwd, G), dot(F, back)
	assert abs(lhs - rhs) <= 1e-12*abs(lhs)


@pytest.mark.parametrize("spins", list(SPINS))
def test_entries_match_reference(spins):
	shape, jwcs, wcs = geometry("F1")
	spin, ncomp = SPINS[spins]
	m, a = inputs(shape, spin, ncomp, False, seed=11)
	ainfo = curvedsky.alm_info(lmax=LMAX)
	jm = np.asarray(jcurvedsky.map2alm_adjoint(a, jenmap.zeros(m.shape, jwcs), spin=spin))
	ja = np.asarray(jcurvedsky.alm2map_adjoint(jenmap.ndmap(m, jwcs), spin=spin, ainfo=ainfo))
	tm, ta = cpu_map(m, wcs), torch.from_numpy(a)
	out = enmap.zeros(m.shape, wcs, device="cpu")
	got = curvedsky.map2alm_adjoint(ta, out, spin=spin)
	assert got is out and rel(got.data, jm) <= 1e-10
	out = enmap.zeros(m.shape, wcs, device="cpu")
	got = curvedsky.map2alm(out, ta, spin=spin, adjoint=True)
	assert got is out and rel(got.data, jm) <= 1e-10
	assert rel(curvedsky.alm2map_adjoint(tm, spin=spin, ainfo=ainfo), ja) <= 1e-10
	# alm2map(adjoint=True) writes into the given alm, or with copy into a copy
	given = torch.zeros_like(ta)
	got = curvedsky.alm2map(given, tm, spin=spin, adjoint=True, copy=True)
	assert got is not given and bool((given == 0).all()) and rel(got, ja) <= 1e-10
	got = curvedsky.alm2map(given, tm, spin=spin, adjoint=True)
	assert got is given and rel(given, ja) <= 1e-10


def test_float32_accuracy_high(monkeypatch):
	"""accuracy= on the adjoint entries: "high" runs the float32 maps'
	recurrence in float64, the default in float32."""
	seen = []
	for fn in ("synthesis_scan", "analysis_scan"):
		orig = getattr(sht_cuda, fn)
		def spy(*args, orig=orig, **kw):
			seen.append(kw["dtype"])
			return orig(*args, **kw)
		monkeypatch.setattr(sht_cuda, fn, spy)
	shape, _, wcs = geometry("F1")
	m, a = inputs(shape, [0], None, False, seed=5)
	tm = cpu_map(m.astype(np.float32), wcs)
	ta = torch.from_numpy(a.astype(np.complex64))
	for acc, want in ((None, torch.float32), ("high", torch.float64)):
		seen.clear()
		curvedsky.alm2map_adjoint(tm, spin=[0], ainfo=curvedsky.alm_info(lmax=LMAX), accuracy=acc)
		curvedsky.map2alm_adjoint(ta, enmap.zeros(shape, wcs, torch.float32, device="cpu"), spin=[0],
			accuracy=acc)
		curvedsky.alm2map(ta, tm, spin=[0], adjoint=True, accuracy=acc, copy=True)
		curvedsky.map2alm(enmap.zeros(shape, wcs, torch.float32, device="cpu"), ta, spin=[0],
			adjoint=True, accuracy=acc)
		assert seen == [want]*4
	assert not sht.ACCURACY_HIGH
