"""pixell_tpu_torch.reproject's thumbnails and small helpers against
pixell_tpu on the CPU in float64, with inputs from a numpy seed:

- thumbnails of an IQU map on the 2-degree full-sky Fejer-1 grid (made
  from alm at lmax 40) around 3 objects: the batch against one call per
  object within 1e-12, against the reference within THUMB_TOL (its
  polarization angle comes from a finite offset of 5e-7 rad, whose
  rounding torch's and numpy's trigonometry reach differently); the
  intensity alone, thumbnails_ivar and postage_stamp within 1e-12;
- populate, distribute, inv_euler, rot2euler, restrict_nside, rotate_map;
- the names that raise in the reference, raising the same errors, and
  enmap's HEALPix distance names against the reference's within 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import reproject as jreproject, enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import reproject, enmap, utils

LMAX = 40
THUMB_TOL = 1e-8


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def maps(seed=1):
	"""An IQU map on the 2-degree F1 grid: (reference ndmap, port ndmap on
	CPU tensors)."""
	rng = np.random.default_rng(seed)
	n = (LMAX + 1)*(LMAX + 2)//2
	l = np.concatenate([np.arange(m, LMAX + 1) for m in range(LMAX + 1)])
	a = (rng.standard_normal((3, n)) + 1j*rng.standard_normal((3, n)))/(1.0 + l)
	a[:, :LMAX+1] = a[:, :LMAX+1].real
	a[1:, l < 2] = 0
	shape, wcs = jenmap.fullsky_geometry(res=2*utils.degree, variant="fejer1")
	jm = jcurvedsky.alm2map(jnp.asarray(a), jenmap.zeros((3,) + shape, wcs), spin=[0, 2])
	_, pwcs = enmap.fullsky_geometry(res=2*utils.degree, variant="fejer1")
	return jm, enmap.ndmap(torch.from_numpy(np.array(jm)), pwcs)


def test_thumbnails():
	jm, m = maps()
	coords = np.array([[0.4, 1.0], [-0.6, 4.0], [1.2, 3.1]])   # dec, ra
	kw = dict(r=10*utils.degree, res=1*utils.degree)
	batch = reproject.thumbnails(m, coords, **kw)
	assert batch.shape == (3, 3, 21, 21) and batch.dtype == torch.float64
	singles = torch.stack([reproject.thumbnails(m, coords[i], **kw)[0] for i in range(3)])
	assert rel(batch.data, singles) <= 1e-12
	want = np.asarray(jreproject.thumbnails(jm, coords, **kw))
	assert rel(batch.data, want) < THUMB_TOL
	# unpolarized, the intensity alone, and the ivar form (order 1, extensive)
	t = reproject.thumbnails(m[0], coords, **kw)
	assert rel(t.data, np.asarray(jreproject.thumbnails(jm[0], coords, **kw))) < 1e-12
	iv = reproject.thumbnails_ivar(m[0], coords, **kw)
	assert rel(iv.data, np.asarray(jreproject.thumbnails_ivar(jm[0], coords, **kw))) < 1e-12
	ps = reproject.postage_stamp(m[0], 57.3, 22.9, 600, 60)
	assert rel(ps.data, np.asarray(jreproject.postage_stamp(jm[0], 57.3, 22.9, 600, 60))) < 1e-12


def test_small_helpers():
	assert reproject.distribute(1000, 400) == jreproject.distribute(1000, 400)
	assert reproject.distribute(7, 400) == jreproject.distribute(7, 400) == [7]
	assert reproject.inv_euler([0.1, 0.2, 0.3]) == jreproject.inv_euler([0.1, 0.2, 0.3])
	assert reproject.rot2euler("gal,equ") == jreproject.rot2euler("gal,equ")
	shape, wcs = enmap.fullsky_geometry(res=2*utils.degree)
	jshape, jwcs = jenmap.fullsky_geometry(res=2*utils.degree)
	assert reproject.restrict_nside(1024, shape, wcs) == jreproject.restrict_nside(1024, jshape, jwcs)
	bshape, bwcs = enmap.geometry(pos=np.array([[-10, 20], [10, -20]])*utils.degree, shape=(900, 1700),
		proj="car")
	jbshape, jbwcs = jenmap.geometry(pos=np.array([[-10, 20], [10, -20]])*utils.degree, shape=(900, 1700),
		proj="car")
	fn = lambda sh, w: enmap.posmap(sh, w, device="cpu")[0]
	jfn = lambda sh, w: jenmap.posmap(sh, w)[0]
	got = reproject.populate(bshape, bwcs, fn, device="cpu")
	want = jreproject.populate(jbshape, jbwcs, jfn)
	assert got.data.dtype == torch.float64 and rel(got.data, want) <= 1e-14
	np.testing.assert_array_equal(got.data.numpy(), fn(bshape, bwcs).data.numpy())
	# rotate_map is project onto the given geometry (the map's own without one)
	m = enmap.ndmap(torch.from_numpy(np.random.default_rng(9).standard_normal((4, 8))), enmap.fullsky_geometry(
		shape=(4, 8))[1])
	cshape, cwcs = enmap.geometry(pos=np.array([[-30, 60], [30, -60]])*utils.degree, res=20*utils.degree, proj="cea")
	assert torch.equal(reproject.rotate_map(m, cshape, cwcs).data, enmap.project(m, cshape, cwcs).data)
	assert torch.equal(reproject.rotate_map(m).data, enmap.project(m, m.shape, m.wcs).data)


def test_raising_names():
	m = enmap.zeros((4, 8), enmap.fullsky_geometry(shape=(4, 8))[1], device="cpu")
	for name in ("healpix_from_enmap", "healpix_from_enmap_interp", "enmap_from_healpix",
			"enmap_from_healpix_interp", "ivar_hp_to_cyl", "gnomonic_pole_wcs", "gnomonic_pole_geometry",
			"get_rotated_pixels", "cutout", "rect_box", "get_pixsize_rect", "rect_geometry",
			"thumbnails_healpix", "centered_map"):
		args = {"healpix_from_enmap": (m, 8, 4), "healpix_from_enmap_interp": (m,),
			"enmap_from_healpix": (None, None, None), "enmap_from_healpix_interp": (None, None, None),
			"ivar_hp_to_cyl": (None, None, None), "gnomonic_pole_wcs": (None, None),
			"gnomonic_pole_geometry": (None, None), "get_rotated_pixels": (None, None, None, None),
			"cutout": (m,), "rect_box": (1,), "get_pixsize_rect": (None, None),
			"rect_geometry": (1, 1), "thumbnails_healpix": (m, None), "centered_map": (m, 1)}[name]
		with pytest.raises(Exception) as want:
			getattr(jreproject, name)(*args)
		with pytest.raises(want.type) as got:
			getattr(reproject, name)(*args)
		assert str(got.value) == str(want.value), name
	# enmap's HEALPix distance names, once NotImplementedError, against the reference
	rng = np.random.default_rng(9)
	pts = np.array([np.arcsin(rng.uniform(-1, 1, 20)), rng.uniform(0, 2*np.pi, 20)])
	for domains in (False, True):
		want = jenmap.distance_from_healpix(4, pts, domains=domains, rmax=0.5)
		got = enmap.distance_from_healpix(4, pts, domains=domains, rmax=0.5, device="cpu")
		for g, w in zip(got if domains else [got], want if domains else [want]):
			assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-12
	mask = rng.uniform(size=192) > 0.1
	assert np.abs(enmap.distance_transform_healpix(mask, device="cpu").numpy()
		- jenmap.distance_transform_healpix(mask)).max() <= 1e-12
	labels = rng.integers(0, 5, 192)*(rng.uniform(size=192) > 0.8)
	for g, w in zip(enmap.labeled_distance_transform_healpix(labels, device="cpu"),
			jenmap.labeled_distance_transform_healpix(labels)):
		assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-12


