"""The curved-sky half of pixell_tpu_torch.lensing against pixell_tpu on the
CPU, with inputs made from a numpy seed:

- offset_by_grad (with and without pol, geodesic and not),
  offset_by_grad_helper and pole_wrap within 1e-12 of the largest
  reference value, numpy in and out, and tensors in and out;
- lens_map_curved on band_geometry(20 degrees, res=2 degrees) (20 x 180
  pixels) at lmax 24, spin [0] (one T alm) and IQU, every output letter
  ("lupka"), against the reference's point_eval="gather" within 1e-9 of
  the largest value (the NUFFT's epsilon is 1e-10 in float64; on the CPU
  the point stage is K10's twin); float32 IQU by the float32 rule (the
  port's and the reference's float32 lensed maps each against the
  reference's float64, the port's error within twice the reference's plus
  2e-5);
- banded (delta_theta) against unbanded within 1e-14: the tail band
  overlaps the one before, so each pixel is the same point evaluation;
- every point_eval runs the same evaluation, any other value raises, mesh=
  that is no DeviceMesh raises TypeError, and a one-rank gloo mesh gives the
  one-device map within 1e-10;
- rand_alm (one seed, and phi_seed) equal to the reference's, and rand_map
  within 1e-9;
- a non-separable (TAN) patch, banded, within 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import lensing as jlensing, enmap as jenmap
from pixell_tpu_torch import lensing, enmap, utils

LMAX = 24
F32_TOL = 2e-5


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def spectra(lmax=LMAX):
	"""[phi, T, E, B] spectra: a deflection of tens of arcminutes, so the
	displaced points are far from the pixels."""
	l = np.arange(lmax + 1.0)
	ps = np.zeros((4, 4, lmax + 1))
	ps[0, 0] = 1e-3/np.maximum(l*(l + 1), 1)
	ps[1, 1] = 1/np.maximum(l, 1)**2
	ps[2, 2] = 0.1/np.maximum(l, 1)**2
	ps[3, 3] = 0.01/np.maximum(l, 1)**2
	return ps


def geometries():
	dec = 20*utils.degree
	return jenmap.band_geometry(dec, res=2*utils.degree), enmap.band_geometry(dec, res=2*utils.degree)


def points(seed, n=400):
	rng = np.random.default_rng(seed)
	pos = np.array([rng.uniform(-1.5, 1.5, n), rng.uniform(-4, 8, n)])
	grad = rng.standard_normal((2, n))*np.array([[0.02], [0.05]])
	grad[:, :20] = 0
	grad[:, 20:30] *= 1e-17
	return pos, grad


@pytest.mark.parametrize("pol", [False, True])
@pytest.mark.parametrize("geodesic", [True, False])
def test_offset_by_grad(pol, geodesic):
	pos, grad = points(0)
	want = np.asarray(jlensing.offset_by_grad(pos, grad, pol=pol, geodesic=geodesic))
	got = lensing.offset_by_grad(pos, grad, pol=pol, geodesic=geodesic)
	assert isinstance(got, np.ndarray) and rel(got, want) < 1e-12
	got = lensing.offset_by_grad(torch.from_numpy(pos), torch.from_numpy(grad), pol=pol, geodesic=geodesic)
	assert isinstance(got, torch.Tensor) and rel(got, want) < 1e-12


@pytest.mark.parametrize("pol", [False, True])
def test_offset_by_grad_helper(pol):
	pos, grad = points(1)
	pos[0] = np.pi/2 - pos[0]   # colatitude
	want = jlensing.offset_by_grad_helper(pos, grad, pol)
	for arg in (lambda x: x, torch.from_numpy):
		got = lensing.offset_by_grad_helper(arg(pos), arg(grad), pol)
		assert rel(got[0], want[0]) < 1e-12
		assert (got[1] is None) == (not pol)
		if pol: assert rel(got[1], want[1]) < 1e-12


def test_pole_wrap():
	rng = np.random.default_rng(2)
	pos = np.array([rng.uniform(-2.5, 2.5, 200), rng.uniform(0, 6, 200)])
	want = jlensing.pole_wrap(pos)
	assert rel(lensing.pole_wrap(pos), want) < 1e-12
	t = torch.from_numpy(pos.copy())
	assert rel(lensing.pole_wrap(t), want) < 1e-12
	assert bool((t == torch.from_numpy(pos)).all())   # a copy


def alms(seed=3, phi_seed=None):
	jp, jc = jlensing.rand_alm(spectra(), lmax=LMAX, seed=seed, phi_seed=phi_seed)
	p, c = lensing.rand_alm(spectra(), lmax=LMAX, seed=seed, phi_seed=phi_seed, device="cpu")
	return np.asarray(jp), np.asarray(jc), p, c


@pytest.mark.parametrize("case", ["spin0", "IQU"])
def test_lens_map_curved(case):
	(jshape, jwcs), (shape, wcs) = geometries()
	jp, jc, p, c = alms()
	if case == "spin0": jc, c, spin, pre = jc[0], c[0], [0], ()
	else: spin, pre = [0, 2], (3,)
	want = jlensing.lens_map_curved(shape=pre + jshape, wcs=jwcs, phi_alm=jp, cmb_alm=jc, spin=spin,
		output="lupka", point_eval="gather")
	got = lensing.lens_map_curved(shape=pre + shape, wcs=wcs, phi_alm=p, cmb_alm=c, spin=spin, output="lupka")
	for w, g, letter in zip(want, got, "lupka"):
		assert isinstance(g, enmap.ndmap) and g.wcs == wcs
		assert rel(g.data, w) < 1e-9, letter
	# the lensed map moved: the deflection is not negligible here
	assert rel(got[0].data, got[1].data) > 1e-2
	# banded: bands of 5 degrees (3 rows of 2; the last band overlaps)
	banded = lensing.lens_map_curved(shape=pre + shape, wcs=wcs, phi_alm=p, cmb_alm=c, spin=spin,
		delta_theta=5*utils.degree)
	assert rel(banded.data, got[0].data) < 1e-14
	for pe in ("rowband", "auto"):
		other = lensing.lens_map_curved(shape=pre + shape, wcs=wcs, phi_alm=p, cmb_alm=c, spin=spin, point_eval=pe)
		assert rel(other.data, got[0].data) == 0


def test_lens_map_curved_float32():
	(jshape, jwcs), (shape, wcs) = geometries()
	jp, jc, p, c = alms()
	kw = dict(output="l", point_eval="gather")
	want = np.asarray(jlensing.lens_map_curved(shape=(3,) + jshape, wcs=jwcs, phi_alm=jp, cmb_alm=jc, **kw))
	ref32 = np.asarray(jlensing.lens_map_curved(shape=(3,) + jshape, wcs=jwcs, phi_alm=jp, cmb_alm=jc,
		dtype=np.float32, **kw))
	got = lensing.lens_map_curved(shape=(3,) + shape, wcs=wcs, phi_alm=p, cmb_alm=c, dtype=np.float32, **kw)
	assert got.dtype == torch.float32
	eport, eref = rel(got.data.double(), want), rel(ref32.astype(np.float64), want)
	assert eport <= 2*eref + F32_TOL, (eport, eref)


def test_lens_map_curved_refusals():
	(jshape, jwcs), (shape, wcs) = geometries()
	_, _, p, c = alms()
	with pytest.raises(ValueError):
		lensing.lens_map_curved(shape=shape, wcs=wcs, phi_alm=p, cmb_alm=c, point_eval="shift")
	with pytest.raises(TypeError):
		lensing.lens_map_curved(shape=shape, wcs=wcs, phi_alm=p, cmb_alm=c, mesh=object())
	# a one-rank gloo mesh gives the one-device map (1e-10 of the largest value;
	# tests/test_torch_parallel_mesh.py runs 2 and 4 ranks)
	import torch_dist_worker
	want = lensing.lens_map_curved(shape=(3,) + shape, wcs=wcs, phi_alm=p, cmb_alm=c, output="l")
	with torch_dist_worker.one_rank_mesh() as mesh:
		got = lensing.lens_map_curved(shape=(3,) + shape, wcs=wcs, phi_alm=p, cmb_alm=c, output="l", mesh=mesh)
	assert rel(got.data.numpy(), want.data.numpy()) <= 1e-10


def test_rand_alm_and_rand_map():
	for phi_seed in (None, 7):
		jp, jc, p, c = alms(seed=5, phi_seed=phi_seed)
		np.testing.assert_array_equal(p.numpy(), jp)
		np.testing.assert_array_equal(c.numpy(), jc)
		assert p.dtype == torch.complex128
	(jshape, jwcs), (shape, wcs) = geometries()
	want = np.asarray(jlensing.rand_map((3,) + jshape, jwcs, spectra(), lmax=LMAX, seed=5, phi_seed=7))
	got = lensing.rand_map((3,) + shape, wcs, spectra(), lmax=LMAX, seed=5, phi_seed=7, device="cpu")
	assert rel(got.data, want) < 1e-9


def test_lens_map_curved_nonseparable():
	"""A TAN patch, whose positions are not separable: each band's posmap
	rows."""
	center = np.array([10, 30])*utils.degree
	jshape, jwcs = jenmap.geometry(pos=center, res=2*utils.degree, shape=(10, 12), proj="tan")
	shape, wcs = enmap.geometry(pos=center, res=2*utils.degree, shape=(10, 12), proj="tan")
	jp, jc, p, c = alms()
	want = np.asarray(jlensing.lens_map_curved(shape=(3,) + jshape, wcs=jwcs, phi_alm=jp, cmb_alm=jc,
		point_eval="gather"))
	got = lensing.lens_map_curved(shape=(3,) + shape, wcs=wcs, phi_alm=p, cmb_alm=c, delta_theta=4*utils.degree)
	assert rel(got.data, want) < 1e-9
