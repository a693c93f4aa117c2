"""pixell_tpu_torch.wavelets (curved sky) against pixell_tpu.wavelets on the
CPU, with inputs made from a numpy seed, float64:

- every basis (Butterworth, ButterTrim, DigitalButterTrim, CosineNeedlet,
  AdriSD, VarButter): kernel(i, l), lbounds, lmaxs and n within 1e-14 of
  the largest reference value; trim_kernel, digitize; utils.czeros and
  utils.RadialFourierTransform (which VarButter runs on) within 1e-14;
- the wavelet geometries (curved, flat, and the curved helper on a patch
  across RA = 180): shapes exactly equal, the WCS within 1e-12;
- map2wave per scale and wave2map for ButterTrim in curved mode, within
  1e-10, on BASELINE config 5's geometry rule at lmax 32 (the 35 x 70 F1
  map), and with offload=True: every scale's map on the CPU, the
  reconstruction equal to the one without offload;
- config 5's chain end to end at lmax 32 with 50 sources (sim_objects ->
  map2wave -> wave2map) within 1e-10, and the identity the chip's guard
  holds at lmax 10000: wave2map(map2wave(m)) = harm2map(sum_i k_i^2
  map2harm(m)), within 1e-10;
- HaarTransform within 1e-12; get_ls, get_variance_transform;
- mesh= that is no DeviceMesh raises TypeError; a one-rank gloo mesh gives
  the one-device decomposition (1e-10) and offload resolves to False
  (tests/test_torch_parallel_mesh.py runs 2 and 4 ranks).
CosineNeedlet's curved transform and the flat sky's transforms are in
test_torch_wavelets_flat.py (each file compiles the reference's programs
of its own scales).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import wavelets as jwavelets, uharm as juharm, enmap as jenmap, pointsrcs as jpointsrcs, \
	curvedsky as jcurvedsky, utils as jutils
from pixell_tpu_torch import wavelets, uharm, enmap, pointsrcs, curvedsky, utils
from pixell_tpu_torch import fft as enfft

LMAX = 32
WTOL = 1e-10   # map2wave / wave2map
BTOL = 1e-14   # the bases


def host(x):
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().numpy()
	return np.asarray(x)


def rel(got, want):
	got, want = host(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def c5_geometry(mod, lmax=LMAX):
	"""Config 5's map: the smallest full-sky F1 grid with >= lmax + 2 rings
	and a 2357-smooth column count (scripts/benchmark_baseline.py:180-185)."""
	ny = lmax + 2
	while enfft.fft_len(2*ny, "above") != 2*ny: ny += 1
	return mod.fullsky_geometry(res=180.0*60/ny*utils.arcmin, variant="fejer1")


def bases(mod):
	return {"butterworth": mod.Butterworth(step=2), "buttertrim": mod.ButterTrim(step=2),
		"digital": mod.DigitalButterTrim(step=2), "needlet": mod.CosineNeedlet(), "adri": mod.AdriSD(),
		"varbutter": mod.VarButter(step=2)}


@pytest.mark.parametrize("name", list(bases(wavelets)))
def test_bases(name):
	jb, pb = bases(jwavelets)[name].with_bounds(10, 500), bases(wavelets)[name].with_bounds(10, 500)
	assert pb.n == jb.n
	l = np.arange(0, 601, dtype=float)
	for i in range(jb.n):
		assert rel(pb.kernel(i, l), jb.kernel(i, l)) <= BTOL
		assert rel(pb(i, l), jb(i, l)) <= BTOL
		if hasattr(jb, "lbounds"): assert pb.lbounds(i) == jb.lbounds(i)
	if name not in ("digital", "needlet"): assert np.array_equal(pb.lmaxs, jb.lmaxs)
	if name in ("butterworth", "buttertrim"):
		vj, vp = jb.get_variance_basis(), pb.get_variance_basis()
		assert rel(vp.kernel(1, l), vj.kernel(1, l)) <= BTOL


def test_helpers():
	a = np.linspace(-0.2, 1.2, 101)
	assert np.array_equal(wavelets.trim_kernel(a, 1e-3), jwavelets.trim_kernel(a, 1e-3))
	s = 0.5 + 0.5*np.sin(np.linspace(0, 9, 200))
	assert np.array_equal(wavelets.digitize(s), jwavelets.digitize(s))
	z = utils.czeros((3, 4), torch.complex128, device="cpu")
	assert z.dtype == torch.complex128 and not z.abs().any()
	assert utils.czeros(5, np.complex64, device="cpu").dtype == torch.complex64
	jr, pr = jutils.RadialFourierTransform(), utils.RadialFourierTransform()
	f = lambda r: np.exp(-0.5*(r/1e-3)**2)
	assert rel(pr.l, jr.l) <= BTOL and rel(pr.r, jr.r) <= BTOL
	F = pr.real2harm(f)
	assert rel(F, jr.real2harm(f)) <= BTOL
	assert rel(pr.harm2real(F), jr.harm2real(F)) <= BTOL
	assert rel(pr.unpad(F), jr.unpad(F)) == 0
	assert rel(pr.lind(np.array([10.0, 300.0])), jr.lind(np.array([10.0, 300.0]))) <= BTOL
	assert rel(pr.rind(np.array([1e-3])), jr.rind(np.array([1e-3]))) <= BTOL


def same_geometry(pg, jg):
	assert tuple(pg[0]) == tuple(int(n) for n in jg[0])
	for attr in ("crpix", "cdelt", "crval"):
		assert np.abs(np.asarray(getattr(pg[1].wcs, attr)) - np.asarray(getattr(jg[1].wcs, attr))).max() <= 1e-12
	assert list(pg[1].wcs.ctype) == list(jg[1].wcs.ctype)


def test_geometries():
	(js, jw), (ps, pw) = c5_geometry(jenmap, 200), c5_geometry(enmap, 200)
	for ores in (0.02, 0.05, 0.3):
		same_geometry(wavelets.make_wavelet_geometry_curved(ps, pw, ores),
			jwavelets.make_wavelet_geometry_curved(js, jw, ores))
	box = np.array([[-20, 200], [10, 150]])*utils.degree   # a patch across RA = 180
	(js, jw), (ps, pw) = [mod.geometry(pos=box, res=0.5*utils.degree, proj="car") for mod in (jenmap, enmap)]
	for ores in (0.02, 0.05):
		same_geometry(wavelets.make_wavelet_geometry_curved(ps, pw, ores),
			jwavelets.make_wavelet_geometry_curved(js, jw, ores))
	for lm in (20, 100, 1000):
		same_geometry(wavelets.make_wavelet_geometry(ps, pw, lm), jwavelets.make_wavelet_geometry(js, jw, lm))
	same_geometry(wavelets.make_wavelet_geometry_flat(ps, pw, 0.01, 0.03),
		jwavelets.make_wavelet_geometry_flat(js, jw, 0.01, 0.03))
	# the scales of config 5's transform at lmax 200, and of a flat patch
	(js, jw), (ps, pw) = c5_geometry(jenmap, 200), c5_geometry(enmap, 200)
	jt = jwavelets.WaveletTransform(juharm.UHT(js, jw, mode="curved", lmax=200), basis=jwavelets.ButterTrim(step=2))
	pt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=200, device="cpu"),
		basis=wavelets.ButterTrim(step=2))
	assert pt.nlevel == jt.nlevel and [u.lmax for u in pt.uhts] == [u.lmax for u in jt.uhts]
	for pg, jg in zip(pt.geometries, jt.geometries): same_geometry(pg, jg)
	for i in range(pt.nlevel): assert rel(pt.get_ls(i), jt.get_ls(i)) == 0
	(js, jw), (ps, pw) = [mod.geometry(pos=np.array([[-4, 4], [4, -4]])*utils.degree, res=0.125*utils.degree,
		proj="car") for mod in (jenmap, enmap)]
	jt, pt = jwavelets.WaveletTransform((js, jw)), wavelets.WaveletTransform((ps, pw), device="cpu")
	assert pt.uht.mode == jt.uht.mode == "flat" and pt.nlevel == jt.nlevel
	for pg, jg in zip(pt.geometries, jt.geometries): same_geometry(pg, jg)
	for i in range(pt.nlevel): assert rel(pt.get_ls(i), jt.get_ls(i)) <= 1e-12


@pytest.fixture(scope="module", params=["buttertrim"])
def curved(request):
	"""(reference transform, port transform, the same seeded band-limited
	map as (reference, port)) on config 5's geometry at lmax 32."""
	(js, jw), (ps, pw) = c5_geometry(jenmap), c5_geometry(enmap)
	jb, pb = bases(jwavelets)[request.param], bases(wavelets)[request.param]
	jt = jwavelets.WaveletTransform(juharm.UHT(js, jw, mode="curved", lmax=LMAX), basis=jb)
	pt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=LMAX, device="cpu"), basis=pb)
	d = np.random.default_rng(5).standard_normal(tuple(js[-2:]))
	return jt, pt, jenmap.ndmap(d, jw), enmap.ndmap(torch.from_numpy(d), pw)


def test_curved(curved):
	jt, pt, jm, pm = curved
	jw, pw = jt.map2wave(jm), pt.map2wave(pm)
	assert pw.nmap == jw.nmap == pt.nlevel
	for a, b in zip(jw.maps, pw.maps): assert rel(b, a) <= WTOL
	rec = pt.wave2map(pw)
	assert rel(rec, jt.wave2map(jw)) <= WTOL
	# offloaded: every scale on the CPU, the same reconstruction
	po = wavelets.WaveletTransform(pt.uht, basis=pt.basis, offload=True)
	wo = po.map2wave(pm)
	assert all(m.data.device.type == "cpu" for m in wo.maps)
	assert rel(po.wave2map(wo), rec) == 0


def c5_catalogue(nsrc=50):
	"""Config 5's catalogue (scripts/benchmark_baseline.py:189-195) at 50
	sources, with a Gaussian of 5 degrees out to 30 (the 2' one of the full
	size is below this map's 5-degree pixels)."""
	rng = np.random.default_rng(0)
	poss = np.array([rng.uniform(-1.2, 1.2, nsrc), rng.uniform(-np.pi, np.pi, nsrc)])
	amps = rng.uniform(0.5, 2.0, nsrc)
	r = np.linspace(0, 30*utils.degree, 1000)
	return poss, amps, (r, np.exp(-0.5*(r/(5*utils.degree))**2))


def test_config5_chain():
	(js, jw), (ps, pw) = c5_geometry(jenmap), c5_geometry(enmap)
	poss, amps, prof = c5_catalogue()
	jm = jpointsrcs.sim_objects(js, jw, poss, amps, prof, dtype=np.float64)
	pm = pointsrcs.sim_objects(ps, pw, poss, amps, prof, dtype=np.float64, device="cpu")
	assert rel(pm, jm) <= 1e-12
	jt = jwavelets.WaveletTransform(juharm.UHT(js, jw, mode="curved", lmax=LMAX),
		basis=jwavelets.ButterTrim(step=2))
	pt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=LMAX, device="cpu"),
		basis=wavelets.ButterTrim(step=2))
	jwv, pwv = jt.map2wave(jm), pt.map2wave(pm)
	for a, b in zip(jwv.maps, pwv.maps): assert rel(b, a) <= WTOL
	rec = pt.wave2map(pwv)
	assert rel(rec, jt.wave2map(jwv)) <= WTOL
	# the chip's guard 1: the scales' geometries are exact for their bandlimits,
	# so the chain is the alm filtered by sum_i k_i^2
	l = np.arange(LMAX + 1, dtype=float)
	k2 = sum(np.where(l <= u.lmax, pt.basis.kernel(i, l), 0)**2 for i, u in enumerate(pt.uhts))
	ref = pt.uht.harm2map(curvedsky.almxfl(pt.uht.map2harm(pm), k2, ainfo=pt.uht.ainfo))
	assert rel(rec, host(ref)) <= WTOL


def test_haar():
	(js, jw), (ps, pw) = [mod.geometry(pos=np.array([[-2, 2], [2, -2]])*utils.degree, shape=(32, 32), proj="car")
		for mod in (jenmap, enmap)]
	d = np.random.default_rng(4).standard_normal((3, 32, 32))
	jh, ph = jwavelets.HaarTransform(3), wavelets.HaarTransform(3)
	jw_, pw_ = jh.map2wave(jenmap.ndmap(d, jw)), ph.map2wave(enmap.ndmap(torch.from_numpy(d), pw))
	assert pw_.nmap == jw_.nmap
	for a, b in zip(jw_.maps, pw_.maps): assert rel(b, a) <= 1e-12
	assert rel(ph.wave2map(pw_), jh.wave2map(jw_)) <= 1e-12
	assert wavelets.HaarTransform().map2wave(enmap.ndmap(torch.from_numpy(d), pw)).nmap == \
		jwavelets.HaarTransform().map2wave(jenmap.ndmap(d, jw)).nmap


def test_variance_transform_and_mesh():
	ps, pw = c5_geometry(enmap)
	pt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=LMAX, device="cpu"),
		basis=wavelets.ButterTrim(step=2))
	vt = pt.get_variance_transform()
	assert isinstance(vt.basis, wavelets.VarButter) and vt.nlevel == pt.nlevel
	with pytest.raises(TypeError, match="DeviceMesh"):
		wavelets.WaveletTransform((ps, pw), mesh=object(), device="cpu")
	import torch_dist_worker
	m = pt.uht.harm2map(torch.from_numpy(np.random.default_rng(2).standard_normal(pt.uht.nharm) + 0j))
	want = pt.map2wave(m)
	with torch_dist_worker.one_rank_mesh() as mesh:
		dt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=LMAX, device="cpu"),
			basis=wavelets.ButterTrim(step=2), mesh=mesh)
		assert dt.offload is False
		got = dt.map2wave(m)
		for a, b in zip(got.maps, want.maps): assert rel(a, host(b)) <= 1e-10
		assert rel(dt.wave2map(got), host(pt.wave2map(want))) <= 1e-10
