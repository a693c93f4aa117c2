"""The curved-sky slice end to end (spin 0, IQU spin [0, 2], derivatives):
pixell_tpu_torch.curvedsky against pixell_tpu.curvedsky on the same numpy
inputs. Every port call asks for the CPU: the entry points default to CUDA.

The grid is a full-sky Fejer-1 CAR map too coarse for direct quadrature at
this lmax (2 lmax + 1 > ny), so map2alm runs the exact theta upsample.
Tolerances, relative to the largest reference value:
- float64: 1e-10 (same algorithms, other summation order and FFT library);
- float32: 1e-4 (f32 Legendre recurrences in both, ~l*eps apart).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import enmap, curvedsky, wcsutils

LMAX = 16
SHAPE = (20, 40)


def geometry():
	jshape, jwcs = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	shape, wcs = enmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	assert shape == jshape == SHAPE
	return jwcs, wcs


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_roundtrip_matches_reference(dtype, tol):
	jwcs, wcs = geometry()
	tdt = torch.float64 if dtype == np.float64 else torch.float32
	cdt = np.complex128 if dtype == np.float64 else np.complex64
	alm = jcurvedsky.rand_alm(np.ones(LMAX + 1), lmax=LMAX, seed=4).astype(cdt)
	jm = jcurvedsky.alm2map(alm, jenmap.zeros(SHAPE, jwcs, dtype), spin=[0])
	m = curvedsky.alm2map(torch.from_numpy(alm), enmap.zeros(SHAPE, wcs, tdt, device="cpu"),
		spin=[0])
	assert m.dtype == tdt
	assert rel(m.data, jm) <= tol
	tm = enmap.ndmap(torch.from_numpy(np.array(jm)), wcs)
	for niter in (0, 2):
		ja = jcurvedsky.map2alm(jm, lmax=LMAX, spin=[0], niter=niter)
		a = curvedsky.map2alm(tm, lmax=LMAX, spin=[0], niter=niter)
		assert a.dtype == torch.from_numpy(np.zeros(1, cdt)).dtype
		assert rel(a, ja) <= tol, niter
		assert rel(a, alm) <= tol, niter   # exact quadrature recovers the input


def test_accuracy_high_runs_float64_recurrence():
	"""accuracy="high" on a float32 map: both packages run the Legendre
	recurrence in float64, so they agree far below the f32 tolerance
	(the maps are still rounded to float32: 1e-6)."""
	jwcs, wcs = geometry()
	alm = jcurvedsky.rand_alm(np.ones(LMAX + 1), lmax=LMAX, seed=5).astype(np.complex64)
	jm = jcurvedsky.alm2map(alm, jenmap.zeros(SHAPE, jwcs, np.float32), spin=[0],
		accuracy="high")
	m = curvedsky.alm2map(torch.from_numpy(alm),
		enmap.zeros(SHAPE, wcs, torch.float32, device="cpu"), spin=[0], accuracy="high")
	assert rel(m.data, jm) <= 1e-6


def test_alm_services():
	rng = np.random.default_rng(6)
	ps = 1/(1 + np.arange(LMAX + 1.0))**2
	alm = jcurvedsky.rand_alm(ps, lmax=LMAX, seed=7)
	talm = curvedsky.rand_alm(ps, lmax=LMAX, seed=7, device="cpu")
	np.testing.assert_array_equal(talm.numpy(), alm)     # same numpy draws
	alm2 = jcurvedsky.rand_alm(ps, lmax=LMAX, seed=8)
	np.testing.assert_allclose(curvedsky.alm2cl(talm).numpy(), np.asarray(jcurvedsky.alm2cl(alm)),
		rtol=1e-12)
	np.testing.assert_allclose(curvedsky.alm2cl(talm, torch.from_numpy(alm2)).numpy(),
		np.asarray(jcurvedsky.alm2cl(alm, alm2)), rtol=1e-12, atol=1e-15)
	fl = rng.uniform(0.5, 1.5, LMAX + 1)
	np.testing.assert_allclose(curvedsky.almxfl(talm, fl).numpy(),
		np.asarray(jcurvedsky.almxfl(alm, fl)), rtol=1e-14)
	f = lambda l: np.exp(-l/10)
	np.testing.assert_allclose(curvedsky.almxfl(talm, f).numpy(),
		np.asarray(jcurvedsky.almxfl(alm, f)), rtol=1e-14)
	# a rectangular layout goes through the general gather
	rinfo = curvedsky.alm_info(lmax=LMAX, layout="rect")
	jrinfo = jcurvedsky.alm_info(lmax=LMAX, layout="rect")
	ralm = jcurvedsky.rand_alm(ps, ainfo=jrinfo, seed=9)
	tr = curvedsky.rand_alm(ps, ainfo=rinfo, seed=9, device="cpu")
	np.testing.assert_array_equal(tr.numpy(), ralm)
	np.testing.assert_allclose(curvedsky.alm2cl(tr, ainfo=rinfo).numpy(),
		np.asarray(jcurvedsky.alm2cl(ralm, ainfo=jrinfo)), rtol=1e-12)
	np.testing.assert_allclose(curvedsky.almxfl(tr, fl, ainfo=rinfo).numpy(),
		np.asarray(jcurvedsky.almxfl(ralm, fl, ainfo=jrinfo)), rtol=1e-14)


def test_unported_options_raise():
	"""mesh= that is no DeviceMesh raises TypeError, and a one-rank gloo mesh
	gives the one-device results (synthesis 1e-12, analysis 1e-11 of the
	largest value; tests/test_torch_parallel_mesh.py runs 2 and 4 ranks
	against the reference's mesh); deriv=True in the general method's
	analysis raises NotImplementedError (as in the reference). The general
	method itself runs: forced on a full-sky grid, and chosen for a plain
	WCS, every entry gives finite output of the right shape, and the
	synthesis agrees with the 2d path (tests/test_torch_general.py holds
	the rest against the reference)."""
	import torch_dist_worker
	_, wcs = geometry()
	m = enmap.zeros(SHAPE, wcs, device="cpu")
	alm = torch.zeros(curvedsky.alm_info(lmax=LMAX).nelem, dtype=torch.complex128)
	with pytest.raises(TypeError):
		curvedsky.alm2map(alm, m, mesh=object())
	with pytest.raises(TypeError):
		curvedsky.map2alm(m, lmax=LMAX, mesh=object())
	a3 = torch.from_numpy(jcurvedsky.rand_alm(np.ones(LMAX + 1)[None, None]*np.eye(3)[:, :, None], lmax=LMAX,
		seed=6))
	one = curvedsky.alm2map(a3, enmap.zeros((3,) + SHAPE, wcs, device="cpu"), spin=[0, 2])
	with torch_dist_worker.one_rank_mesh() as mesh:
		got = curvedsky.alm2map(a3, enmap.zeros((3,) + SHAPE, wcs, device="cpu"), spin=[0, 2], mesh=mesh)
		assert rel(got.data, one.data.numpy()) <= 1e-12
		back = curvedsky.map2alm(one, lmax=LMAX, spin=[0, 2], mesh=mesh)
	assert rel(back, curvedsky.map2alm(one, lmax=LMAX, spin=[0, 2]).numpy()) <= 1e-11
	with pytest.raises(NotImplementedError):
		curvedsky.map2alm(enmap.zeros((2,) + SHAPE, wcs, device="cpu"), lmax=LMAX, deriv=True,
			method="general")
	a = torch.from_numpy(np.random.default_rng(3).standard_normal(alm.shape) + 0j)
	want = curvedsky.alm2map(a, enmap.zeros(SHAPE, wcs, device="cpu")).data
	got = curvedsky.alm2map(a, enmap.zeros(SHAPE, wcs, device="cpu"), method="general").data
	assert float((got - want).abs().max()) < 1e-10*float(want.abs().max())
	plain = wcsutils.WCS.from_fields(["", ""], [0, 0], [1, 1], [1, 1])
	pm = enmap.zeros(SHAPE, plain, device="cpu")
	for call, shape in ((lambda: curvedsky.map2alm(pm, lmax=LMAX), alm.shape),
			(lambda: curvedsky.alm2map(a, pm).data, SHAPE),
			(lambda: curvedsky.alm2map_adjoint(pm, ainfo=curvedsky.alm_info(lmax=LMAX)), alm.shape),
			(lambda: curvedsky.map2alm_adjoint(a, pm).data, SHAPE),
			(lambda: curvedsky.alm2map(alm, m, adjoint=True, method="general"), alm.shape),
			(lambda: curvedsky.alm2map_general(a, m).data, SHAPE),
			(lambda: curvedsky.map2alm_general(m, lmax=LMAX), alm.shape)):
		out = call()
		assert tuple(out.shape) == tuple(shape) and bool(torch.isfinite(torch.view_as_real(out) if
			out.is_complex() else out).all())


def test_import_loads_no_jax():
	"""The port imports torch and never jax or pixell_tpu."""
	code = ("import sys, pixell_tpu_torch, pixell_tpu_torch.curvedsky, "
		"pixell_tpu_torch.ops.sht_cuda, pixell_tpu_torch.ops.fma_peak, pixell_tpu_torch.lensing, "
		"pixell_tpu_torch.aberration, pixell_tpu_torch.old_aberration, pixell_tpu_torch.ops.solvers, "
		"pixell_tpu_torch.multimap, pixell_tpu_torch.uharm, pixell_tpu_torch.wavelets, pixell_tpu_torch.pointsrcs, "
		"pixell_tpu_torch.parallel.sht_dist, pixell_tpu_torch.tilemap, pixell_tpu_torch.mpi, pixell_tpu_torch.mpiutils, "
		"pixell_tpu_torch.enplot, pixell_tpu_torch.cgrid, pixell_tpu_torch.colorize, pixell_tpu_torch.colors, "
		"pixell_tpu_torch.scripts, pixell_tpu_torch.bench, pixell_tpu_torch.utils, pixell_tpu_torch.parallel.dist; "
		"bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
		"or m == 'pixell_tpu' or m.startswith('pixell_tpu.')]; "
		"print(bad); sys.exit(1 if bad else 0)")
	root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
	r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
		timeout=120, cwd=root)
	assert r.returncode == 0, r.stdout + r.stderr


def test_plotting_imports_without_pil_or_matplotlib():
	"""enplot, colorize, cgrid, scripts and bench import where neither PIL
	nor matplotlib is installed (as on a machine with only the card's
	stack): the two hidden, colorize has its own schemes and not the
	matplotlib ones."""
	code = ("import sys; sys.modules['PIL'] = None; sys.modules['matplotlib'] = None; "
		"from pixell_tpu_torch import enplot, colorize, cgrid, scripts, bench; "
		"assert 'viridis' not in colorize.schemes and 'planck' in colorize.schemes; "
		"assert colorize.colorize([0.5], 'planck').shape == (1, 4); "
		"bad = [m for m in ('PIL', 'matplotlib') if sys.modules.get(m) is not None]; "
		"print(bad); sys.exit(1 if bad else 0)")
	root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
	r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
		timeout=120, cwd=root)
	assert r.returncode == 0, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def iqu_reference():
	"""Random T, E, B alm (a diagonal spectrum without the l < 2 E/B modes a
	spin-2 field cannot carry), their map and its map2alm (niter 0, 2),
	from pixell_tpu in float64."""
	jwcs, _ = geometry()
	ps = np.zeros((3, 3, LMAX + 1))
	ps[0, 0] = 1/(1 + np.arange(LMAX + 1.0))
	ps[1, 1, 2:], ps[2, 2, 2:] = 0.5, 0.25
	alm = jcurvedsky.rand_alm(ps, lmax=LMAX, seed=4)
	jm = np.array(jcurvedsky.alm2map(alm, jenmap.zeros((3,) + SHAPE, jwcs), spin=[0, 2]))
	ja = [np.asarray(jcurvedsky.map2alm(jenmap.ndmap(jm, jwcs), lmax=LMAX, spin=[0, 2],
		niter=n)) for n in (0, 2)]
	return alm, jm, ja


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)],
	ids=["float64", "float32"])
def test_iqu_roundtrip_matches_reference(dtype, tol):
	"""TQU alm2map -> map2alm (niter 0 and 2) with spin [0, 2] on the coarse
	F1 grid (the theta upsample runs, with the spin-2 torus signs), against
	pixell_tpu in float64: the float32 port within 1e-4."""
	_, wcs = geometry()
	alm, jm, ja = iqu_reference()
	cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
	m = curvedsky.alm2map(torch.from_numpy(alm).to(cdt), enmap.zeros((3,) + SHAPE, wcs, dtype,
		device="cpu"), spin=[0, 2])
	assert m.shape == (3,) + SHAPE and m.dtype == dtype
	assert rel(m.data, jm) <= tol
	tm = enmap.ndmap(torch.from_numpy(jm).to(dtype), wcs)
	for niter, want in zip((0, 2), ja):
		a = curvedsky.map2alm(tm, lmax=LMAX, spin=[0, 2], niter=niter)
		assert a.dtype == cdt
		assert rel(a, want) <= tol, niter
		assert rel(a, alm) <= tol, niter   # exact quadrature recovers the input


@functools.lru_cache(maxsize=None)
def deriv_reference():
	"""A random alm, its gradient map (d/ddec, d/dra) and that map's
	map2alm (niter 0, 1), from pixell_tpu in float64."""
	jwcs, _ = geometry()
	alm = jcurvedsky.rand_alm(np.ones(LMAX + 1), lmax=LMAX, seed=6)
	jd = np.array(jcurvedsky.alm2map(alm, jenmap.zeros((2,) + SHAPE, jwcs), deriv=True))
	ja = [np.asarray(jcurvedsky.map2alm(jenmap.ndmap(jd, jwcs), lmax=LMAX, deriv=True,
		niter=n)) for n in (0, 1)]
	return alm, jd, ja


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)],
	ids=["float64", "float32"])
def test_deriv_matches_reference(dtype, tol):
	"""deriv=True alm2map (the gradient as (d/ddec, d/dra): the sign flip of
	d/dtheta) and map2alm of that gradient map, niter 0 and 1, against
	pixell_tpu in float64: the float32 port within 1e-4."""
	_, wcs = geometry()
	alm, jd, ja = deriv_reference()
	cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
	d = curvedsky.alm2map(torch.from_numpy(alm).to(cdt), enmap.zeros((2,) + SHAPE, wcs, dtype,
		device="cpu"), deriv=True)
	assert d.shape == (2,) + SHAPE
	assert rel(d.data, jd) <= tol
	td = enmap.ndmap(torch.from_numpy(jd).to(dtype), wcs)
	for niter, want in zip((0, 1), ja):
		a = curvedsky.map2alm(td, lmax=LMAX, deriv=True, niter=niter)
		assert a.shape == alm.shape and a.dtype == cdt
		assert rel(a, want) <= tol, niter


def test_rand_map():
	"""rand_map: the same numpy draws as rand_alm, synthesized (IQU) onto the
	geometry, against pixell_tpu.curvedsky.rand_map (1e-10); the lmax from
	the pixel size when none is given."""
	jwcs, wcs = geometry()
	ps = np.zeros((3, 3, LMAX + 1)); ps[0, 0] = 1; ps[1, 1, 2:] = ps[2, 2, 2:] = 0.5
	m = curvedsky.rand_map((3,) + SHAPE, wcs, ps, lmax=LMAX, seed=3, device="cpu")
	jm = jcurvedsky.rand_map((3,) + SHAPE, jwcs, ps, lmax=LMAX, seed=3)
	assert m.shape == (3,) + SHAPE and m.dtype == torch.float64
	assert rel(m.data, jm) <= 1e-10
	assert curvedsky.get_lmax_from_map(m) == jcurvedsky.get_lmax_from_map(jm) == SHAPE[0]


def test_entry_points_default_to_cuda():
	"""With no device argument the entry points allocate on CUDA; on a torch
	without a CUDA device they raise and never return a CPU tensor."""
	_, wcs = geometry()
	ainfo = curvedsky.alm_info(lmax=4)
	calls = [lambda: enmap.zeros((2, 2)), lambda: enmap.empty((2, 2)),
		lambda: curvedsky.rand_alm(np.ones(5), lmax=4, seed=0),
		lambda: curvedsky.rand_alm_white(ainfo, seed=0),
		lambda: curvedsky.prepare_alm(lmax=4)[0],
		lambda: curvedsky.rand_map(SHAPE, wcs, np.ones(5), lmax=4, seed=0)]
	for call in calls:
		if torch.cuda.is_available():
			x = call()
			assert (x.data if isinstance(x, enmap.ndmap) else x).device.type == "cuda"
		else:
			with pytest.raises((AssertionError, RuntimeError)):
				call()
