"""enmap's masks and distance transforms in pixell_tpu_torch against
pixell_tpu's on the CPU (float64, inputs from a numpy seed; K13 / K14's
plain versions): distance_transform, labeled_distance_transform and
distance_from (the functions and the ndmap methods), grow_mask,
shrink_mask, mask_from, apod_mask (with and without the edge, both
profiles) and inpaint, within 1e-12.

The reference's inpaint floods from the masked pixels (it passes ~mask to
distance_transform, whose False pixels are the masked ones), so each
masked pixel finds itself and the map comes back unchanged (asserted). The
port fills each masked pixel from the nearest unmasked one, as its
docstring says: held against the reference's own distance_transform
indices of the unmasked pixels (ROADMAP Queue 3). The reference's flood
runs with jax.disable_jit() (see test_torch_distances.py).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, distances as jdist, utils as jutils
from pixell_tpu_torch import enmap

TOL = 1e-12


def geo():
	return jenmap.fullsky_geometry(res=15*jutils.degree)          # 12 x 24, RA wrapped


def inputs(seed=0):
	shape, wcs = geo()
	rng = np.random.default_rng(seed)
	mask = rng.uniform(size=shape) > 0.1
	return shape, wcs, mask, rng


def tmap(a, wcs):
	return enmap.ndmap(torch.from_numpy(np.asarray(a)), wcs)


def err(got, want):
	got = got.data if isinstance(got, enmap.ndmap) else got
	return float(np.max(np.abs(got.numpy() - np.asarray(want)))/max(np.max(np.abs(np.asarray(want))), 1e-300))


def test_enmap_transforms():
	shape, wcs, mask, rng = inputs(1)
	labels = np.zeros(shape, np.int64)
	labels.reshape(-1)[rng.choice(labels.size, 6, replace=False)] = np.arange(1, 7)
	pts = np.array([rng.uniform(-1.3, 1.3, 9), rng.uniform(-np.pi, np.pi, 9)])
	with jax.disable_jit():
		w1 = jenmap.distance_transform(jenmap.ndmap(mask, wcs), rmax=0.5)
		w2, w3 = jenmap.labeled_distance_transform(jenmap.ndmap(labels, wcs), rmax=0.6)
	w4, w5 = jenmap.distance_from(shape, wcs, pts, domains=True, rmax=0.4)
	tm, tl = tmap(mask, wcs), tmap(labels, wcs)
	for got in (enmap.distance_transform(tm, rmax=0.5), tm.distance_transform(rmax=0.5)):
		assert err(got, w1) <= TOL
	for d, l in (enmap.labeled_distance_transform(tl, rmax=0.6), tl.labeled_distance_transform(rmax=0.6)):
		assert err(d, w2) <= TOL and np.array_equal(l.data.numpy(), np.asarray(w3))
	for d, l in (enmap.distance_from(shape, wcs, pts, domains=True, rmax=0.4, device="cpu"),
			tm.distance_from(pts, domains=True, rmax=0.4)):
		assert err(d, w4) <= TOL and np.array_equal(l.data.numpy(), np.asarray(w5))


@pytest.mark.parametrize("r", [0.2, 0.5])
def test_grow_shrink(r):
	shape, wcs, mask, rng = inputs(2)
	with jax.disable_jit():
		g1 = jenmap.grow_mask(jenmap.ndmap(mask, wcs), r)
		s1 = jenmap.shrink_mask(jenmap.ndmap(mask, wcs), r)
	g2 = enmap.grow_mask(tmap(mask, wcs), r)
	s2 = enmap.shrink_mask(tmap(mask, wcs), r)
	assert g2.dtype == torch.bool and np.array_equal(g2.data.numpy(), np.asarray(g1))
	assert np.array_equal(s2.data.numpy(), np.asarray(s1))
	m = tmap(mask, wcs)
	assert enmap.mask_from(m) is m


@pytest.mark.parametrize("edge, profile", [(True, "cos"), (False, "cos"), (True, "lin")])
def test_apod_mask(edge, profile):
	shape, wcs, mask, rng = inputs(3)
	jp = jenmap.apod_profile_cos if profile == "cos" else jenmap.apod_profile_lin
	tp = enmap.apod_profile_cos if profile == "cos" else enmap.apod_profile_lin
	with jax.disable_jit():
		want = jenmap.apod_mask(jenmap.ndmap(mask, wcs), width=40*jutils.degree, edge=edge, profile=jp)
	got = enmap.apod_mask(tmap(mask, wcs), width=40*jutils.degree, edge=edge, profile=tp)
	assert got.dtype == torch.float64 and err(got, want) <= TOL


def test_inpaint():
	shape, wcs, mask, rng = inputs(4)
	m = rng.standard_normal((3,) + shape)
	hole = ~mask                                      # True: the pixels to fill
	with jax.disable_jit():
		ref = jenmap.inpaint(jenmap.ndmap(m, wcs), hole)
		_, inds = jdist.distance_transform(jenmap.ndmap(hole, wcs), return_inds=True)
	assert np.array_equal(np.asarray(ref), m)          # the reference's fill is a no-op
	iy, ix = np.asarray(inds)
	want = m.copy()
	want[..., hole] = m[..., iy[hole], ix[hole]]
	got = enmap.inpaint(tmap(m, wcs), torch.from_numpy(hole))
	assert isinstance(got, enmap.ndmap) and err(got, want) <= TOL
	assert np.array_equal(got.data.numpy()[..., mask], m[..., mask])
	with pytest.raises(NotImplementedError):
		enmap.inpaint(tmap(m, wcs), torch.from_numpy(hole), method="linear")
