"""pixell_tpu_torch.uharm against pixell_tpu.uharm on the CPU, with inputs
made from a numpy seed, float64, within 1e-12 of the largest reference
value (the transforms, the port SHT tests' tolerance):

- UHT in flat mode (chosen by "auto" on a 4 x 4 degree CAR patch) and in
  curved mode (full-sky F1 at lmax 20): map2harm, harm2map and both
  adjoints, quad_weights, rprof2hprof, hprof2harm, mean_hprof,
  lprof2hprof, hmul (1d and matrix profiles), hprof_rpow, hrand (the same
  numpy draws), harm2powspec (auto and cross), sum_hprof, lmap, and
  hprof2rprof in curved mode;
- in flat mode hprof2rprof against the reference's harm2profile_flat_2d on
  the harmonic map (the reference's own hprof2rprof passes it a bare numpy
  array, which has no wcs, and raises AttributeError; the test asserts it);
- estimate_distortion, profile2harm_flat_2d, harm2profile_flat_2d,
  res2lmax, beam2res, beam2rmax, profile2harm_flat;
- mesh= that is no DeviceMesh raises TypeError; a one-rank gloo mesh gives
  the one-device transforms (1e-12; tests/test_torch_parallel_mesh.py runs
  2 and 4 ranks against the reference's mesh).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import uharm as juharm, enmap as jenmap
from pixell_tpu_torch import uharm, enmap, utils

TOL = 1e-12
LMAX = 20


def host(x):
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().numpy()
	return np.asarray(x)


def rel(got, want):
	got, want = host(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def flat_geometry(mod):
	return mod.geometry(pos=np.array([[-2, 2], [2, -2]])*utils.degree, res=0.125*utils.degree, proj="car")


def curved_geometry(mod):
	return mod.fullsky_geometry(shape=(LMAX + 2, 2*LMAX + 4), variant="fejer1")


@pytest.fixture(scope="module", params=["flat", "curved"])
def uhts(request):
	"""(mode, reference UHT, port UHT, seeded map [3, ny, nx] as (reference, port))."""
	mode = request.param
	geo = flat_geometry if mode == "flat" else curved_geometry
	(js, jw), (ps, pw) = geo(jenmap), geo(enmap)
	kw = {} if mode == "flat" else dict(mode="curved", lmax=LMAX)
	ju, pu = juharm.UHT(js, jw, **kw), uharm.UHT(ps, pw, device="cpu", **kw)
	assert ju.mode == pu.mode == mode
	d = np.random.default_rng(1).standard_normal((3,) + tuple(js[-2:]))
	return mode, ju, pu, (jenmap.ndmap(d, jw), enmap.ndmap(torch.from_numpy(d), pw))


def beam():
	r = np.linspace(0, 3*utils.degree, 400)
	return np.exp(-0.5*(r/(0.5*utils.degree))**2), r


def test_attributes(uhts):
	mode, ju, pu, _ = uhts
	assert (pu.shape, pu.lmax, pu.npix, pu.nharm) == (tuple(ju.shape), ju.lmax, ju.npix, ju.nharm)
	assert abs(pu.area - ju.area) <= TOL*ju.area and rel(pu.nper, ju.nper) <= TOL
	assert rel(pu.l, ju.l) <= TOL and abs(pu.ntot - ju.ntot) <= TOL*ju.ntot
	assert rel(pu.lmap(), ju.lmap()) <= TOL


def test_transforms(uhts):
	mode, ju, pu, (jm, pm) = uhts
	jh, ph = ju.map2harm(jm), pu.map2harm(pm)
	assert rel(ph, jh) <= TOL
	assert rel(pu.harm2map(ph), ju.harm2map(jh)) <= TOL
	assert rel(pu.map2harm_adjoint(ph), ju.map2harm_adjoint(jh)) <= TOL
	assert rel(pu.harm2map_adjoint(pm), ju.harm2map_adjoint(jm)) <= TOL
	assert rel(pu.quad_weights(), ju.quad_weights()) <= TOL


def test_profiles(uhts):
	mode, ju, pu, (jm, pm) = uhts
	br, r = beam()
	jhp, php = ju.rprof2hprof(br, r), pu.rprof2hprof(br, r)
	assert rel(php, jhp) <= TOL
	assert rel(pu.hprof2harm(php), ju.hprof2harm(jhp)) <= TOL
	assert rel(pu.mean_hprof(php), ju.mean_hprof(jhp)) <= TOL
	assert rel(pu.sum_hprof(php), ju.sum_hprof(jhp)) <= TOL
	assert rel(pu.hprof_rpow(php, 2), ju.hprof_rpow(jhp, 2)) <= 1e-10 if mode == "curved" else TOL
	lprof = 1/(1 + np.arange(3*LMAX)/5.0)
	jl, pl = ju.lprof2hprof(lprof), pu.lprof2hprof(lprof)
	assert rel(pl, jl) <= TOL
	jh, ph = ju.map2harm(jm), pu.map2harm(pm)
	assert rel(pu.hmul(pl, ph), ju.hmul(jl, jh)) <= TOL
	if mode == "curved":
		mat = np.random.default_rng(2).standard_normal((3, 3, LMAX + 1))
		assert rel(pu.hmul(mat, ph), ju.hmul(mat, jh)) <= TOL
		rr = np.linspace(0, 2*utils.degree, 50)
		assert rel(pu.hprof2rprof(php, rr), ju.hprof2rprof(jhp, rr)) <= TOL
	else:
		rr = np.linspace(0, 1*utils.degree, 50)
		with pytest.raises(AttributeError):
			ju.hprof2rprof(jhp, rr)
		assert rel(pu.hprof2rprof(php, rr), juharm.harm2profile_flat_2d(jhp + 0j, rr)) <= TOL
	assert rel(pu.harm2powspec(ph), ju.harm2powspec(jh)) <= TOL
	assert rel(pu.harm2powspec(ph, ph*2), ju.harm2powspec(jh, jh*2)) <= TOL


def test_hrand(uhts):
	mode, ju, pu, _ = uhts
	hprof = ju.lprof2hprof(1/(1 + np.arange(3*LMAX)))
	assert rel(pu.hrand(uharm._host(pu.lprof2hprof(1/(1 + np.arange(3*LMAX)))), seed=3), ju.hrand(hprof, seed=3)) \
		<= TOL


def test_helpers():
	for geo in (flat_geometry, curved_geometry):
		(js, jw), (ps, pw) = geo(jenmap), geo(enmap)
		assert uharm.estimate_distortion(ps, pw) == juharm.estimate_distortion(js, jw)
	(js, jw), (ps, pw) = flat_geometry(jenmap), flat_geometry(enmap)
	br, r = beam()
	j2 = juharm.profile2harm_flat_2d(br, r, js, jw)
	p2 = uharm.profile2harm_flat_2d(br, r, ps, pw, device="cpu")
	assert rel(p2, j2) <= TOL
	rr = np.linspace(0, utils.degree, 30)
	assert rel(uharm.harm2profile_flat_2d(p2 + 0j, rr), juharm.harm2profile_flat_2d(j2 + 0j, rr)) <= TOL
	assert uharm.res2lmax(0.01) == juharm.res2lmax(0.01)
	assert uharm.beam2res(br, r) == juharm.beam2res(br, r)
	assert uharm.beam2rmax(br, r, return_index=True) == juharm.beam2rmax(br, r, return_index=True)
	assert rel(uharm.profile2harm_flat(br, r), juharm.profile2harm_flat(br, r)) <= TOL


def test_mesh_raises():
	import torch_dist_worker
	shape, wcs = curved_geometry(enmap)
	with pytest.raises(TypeError, match="DeviceMesh"):
		uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, mesh=object())
	one = uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, device="cpu")
	alm = torch.from_numpy(np.random.default_rng(4).standard_normal(one.nharm) + 0j)
	m = one.harm2map(alm)
	with torch_dist_worker.one_rank_mesh() as mesh:
		u = uharm.UHT(shape, wcs, mode="curved", lmax=LMAX, mesh=mesh, device="cpu")
		assert rel(u.harm2map(alm), host(m)) <= TOL
		assert rel(u.map2harm(m), host(one.map2harm(m))) <= TOL
