"""The general-position method of pixell_tpu_torch.curvedsky (the torus
NUFFT) and what runs on it, against pixell_tpu.curvedsky on the CPU in
float64 at lmax 16 (one lmax and one point set throughout, so the
reference compiles each program once), with inputs made from a numpy seed:

- synthesis_general (spin 0 of a flat alm, IQU), alm2map_pos (from pos,
  from loc, deriv=True) and adjoint_synthesis_general within 1e-10 of the
  largest reference value; SynthesisPlan at two point sets;
- adjointness <A x, y> = <x, A^T y> within 1e-10 relative (the torus is
  even, so the zero-pad's Nyquist halving is exercised);
- float32 at theta = 0, pi and 1e-7 (the torus rings include both poles)
  finite and within the reference's 2e-3 (tests/test_curvedsky.py:304);
- alm2map, map2alm (niter 0 and 2) and alm2map_adjoint on a plain WCS and
  on a CAR whose cdelt does not divide 360 degrees, which analyse_geometry
  sends to the general method; map2alm_adjoint's dot-product identity there
  (the reference has no general transpose of map2alm);
- rotate_alm (theta = 0 and a general rotation, spin 0 and IQU), prof2alm
  (spin 0 and 1) and prof2alm_radial;
- the raw general entries against synthesis_general and
  adjoint_synthesis_general called directly, since the reference's raise
  TypeError (they pass ainfo= where no such parameter is taken).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from pixell_tpu import curvedsky as jcurvedsky, enmap as jenmap, wcsutils as jwcsutils
from pixell_tpu_torch import curvedsky, enmap, wcsutils
from pixell_tpu_torch.ops import nufft_cuda

LMAX = 16
NALM = (LMAX + 1)*(LMAX + 2)//2
SHAPE = (24, 48)


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def alm_dot(x, y):
	return float(np.sum(x.real*y.real + x.imag*y.imag))


def rand_alm(seed, ncomp=3):
	rng = np.random.default_rng(seed)
	a = rng.standard_normal((ncomp, NALM)) + 1j*rng.standard_normal((ncomp, NALM))
	a[:, :LMAX+1] = a[:, :LMAX+1].real
	return a


def rand_loc(seed, n=61):
	"""n (colat, phi) points, the first three at theta = 0, pi, 1e-7."""
	rng = np.random.default_rng(seed)
	th = np.concatenate([[0.0, np.pi, 1e-7], rng.uniform(0, np.pi, n - 3)])
	return np.stack([th, rng.uniform(0, 2*np.pi, n)], -1)


SPINS = {"spin0": ([0], 0), "IQU": ([0, 2], None)}


def case(name, seed=1):
	spin, comp = SPINS[name]
	a = rand_alm(seed)
	return spin, (a[comp] if comp is not None else a)


@pytest.mark.parametrize("name", SPINS)
def test_synthesis_general_against_reference(name):
	spin, a = case(name)
	loc = rand_loc(2)
	want = np.asarray(jcurvedsky.synthesis_general(jnp.asarray(a), jnp.asarray(loc), lmax=LMAX, spin=spin))
	got = curvedsky.synthesis_general(torch.from_numpy(a), loc, lmax=LMAX, spin=spin)
	assert got.dtype == torch.float64 and rel(got, want) < 1e-10
	# a plan evaluated at two point sets
	plan = curvedsky.SynthesisPlan(torch.from_numpy(a), lmax=LMAX, spin=spin)
	assert rel(plan.eval(loc[:30]), want[..., :30]) < 1e-10
	assert rel(plan.eval(torch.from_numpy(loc[30:])), want[..., 30:]) < 1e-10


@pytest.mark.parametrize("name", SPINS)
def test_adjoint_synthesis_general(name):
	"""Against the reference's jax.vjp, and adjointness within 1e-10."""
	spin, a = case(name)
	loc = rand_loc(2)
	rng = np.random.default_rng(3)
	vshape = (len(loc),) if a.ndim == 1 else (a.shape[0], len(loc))
	v = rng.standard_normal(vshape)
	want = np.asarray(jcurvedsky.adjoint_synthesis_general(jnp.asarray(v), jnp.asarray(loc), lmax=LMAX,
		spin=spin))
	got = curvedsky.adjoint_synthesis_general(torch.from_numpy(v), loc, lmax=LMAX, spin=spin)
	assert got.dtype == torch.complex128 and rel(got, want) < 1e-10
	fwd = curvedsky.synthesis_general(torch.from_numpy(a), loc, lmax=LMAX, spin=spin).numpy()
	lhs, rhs = float(np.sum(fwd*v)), alm_dot(a, got.numpy())
	assert abs(lhs - rhs) < 1e-10*abs(lhs)


def test_alm2map_pos_against_reference():
	"""From pos [{dec, ra}, ...] (keeping its shape), from loc, and deriv."""
	a = rand_alm(1)
	loc = rand_loc(2)
	pos = np.stack([np.pi/2 - loc[:, 0], loc[:, 1]]).reshape(2, 61, 1)
	want = np.asarray(jcurvedsky.alm2map_pos(jnp.asarray(a), pos=pos))
	got = curvedsky.alm2map_pos(torch.from_numpy(a), pos=pos)
	assert got.shape == (3, 61, 1) and rel(got, want) < 1e-10
	want = np.asarray(jcurvedsky.alm2map_pos(jnp.asarray(a[0]), loc=loc, deriv=True))
	got = curvedsky.alm2map_pos(torch.from_numpy(a[0]), loc=torch.from_numpy(loc), deriv=True)
	assert got.shape == (2, 61) and rel(got, want) < 1e-10


def test_f32_pole_points():
	"""float32 stays finite at the exact poles and at 1e-7, within the
	reference's own bound of the float64 result (the torus ring set
	includes theta = 0 and pi, where the float32 dispatch hands the rings
	to its float64 near-pole pass)."""
	a = rand_alm(5)/np.sqrt(np.arange(1, NALM + 1))
	loc = rand_loc(6, 43)
	v64 = curvedsky.synthesis_general(torch.from_numpy(a), loc, lmax=LMAX, spin=[0, 2]).numpy()
	v32 = curvedsky.synthesis_general(torch.from_numpy(a.astype(np.complex64)), loc, lmax=LMAX,
		spin=[0, 2]).numpy()
	assert v32.dtype == np.float32 and np.isfinite(v32).all()
	assert rel(v32, v64) < 2e-3
	vt = curvedsky.adjoint_synthesis_general(torch.from_numpy(v32), loc, lmax=LMAX, spin=[0, 2])
	assert vt.dtype == torch.complex64 and bool(torch.isfinite(torch.view_as_real(vt)).all())


def port_wcs(w):
	return wcsutils.WCS.from_fields(w.wcs.ctype, w.wcs.crval, w.wcs.crpix, w.wcs.cdelt)


def general_wcs(name):
	"""A reference wcs that analyse_geometry sends to the general method."""
	if name == "plain":
		w = jwcsutils.WCS(naxis=2)
		w.wcs.cdelt = np.array([0.11, 0.09])
		w.wcs.crpix = np.array([10.0, 12.0])
		w.wcs.crval = np.array([1.0, 0.2])
		return w
	_, w = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	w = w.deepcopy()
	w.wcs.cdelt = np.array([-7.3, 7.3])   # 360/7.3 is no whole number of pixels
	return w


@pytest.mark.parametrize("geo", ["plain", "car"])
def test_general_geometry_transforms(geo):
	jw = general_wcs(geo)
	w = port_wcs(jw)
	assert curvedsky.analyse_geometry(SHAPE, w).case == "general"
	assert curvedsky.get_method(SHAPE, w) == "general"
	a = rand_alm(7)
	mj = jcurvedsky.alm2map(jnp.asarray(a), jenmap.zeros((3,) + SHAPE, jw))
	m = curvedsky.alm2map(torch.from_numpy(a), enmap.zeros((3,) + SHAPE, w, device="cpu"))
	assert rel(m.data, np.asarray(mj)) < 1e-10
	mt = enmap.ndmap(torch.from_numpy(np.array(mj)), w)
	for niter in (0, 2):
		want = np.asarray(jcurvedsky.map2alm(mj, lmax=LMAX, niter=niter))
		assert rel(curvedsky.map2alm(mt, lmax=LMAX, niter=niter), want) < 1e-10
	want = np.asarray(jcurvedsky.alm2map_adjoint(mj, ainfo=jcurvedsky.alm_info(lmax=LMAX)))
	got = curvedsky.alm2map_adjoint(mt, ainfo=curvedsky.alm_info(lmax=LMAX))
	assert rel(got, want) < 1e-10
	assert rel(curvedsky.alm2map(torch.zeros(3, NALM, dtype=torch.complex128), mt, adjoint=True), want) \
		< 1e-10
	# the transpose of map2alm, against map2alm
	rng = np.random.default_rng(8)
	x = rng.standard_normal((3,) + SHAPE)
	fwd = curvedsky.map2alm(enmap.ndmap(torch.from_numpy(x), w), lmax=LMAX).numpy()
	back = curvedsky.map2alm_adjoint(torch.from_numpy(a), enmap.zeros((3,) + SHAPE, w, device="cpu"))
	lhs, rhs = alm_dot(fwd, a), float(np.sum(x*back.data.numpy()))
	assert abs(lhs - rhs) < 1e-10*abs(lhs)
	back2 = curvedsky.map2alm(enmap.zeros((3,) + SHAPE, w, device="cpu"), torch.from_numpy(a),
		adjoint=True)
	assert rel(back2.data, back.data) < 1e-15


@pytest.mark.parametrize("angles", [(0.3, 0.0, 0.7), (0.2, 1.1, -0.4)], ids=["z", "general"])
@pytest.mark.parametrize("name", SPINS)
def test_rotate_alm_against_reference(name, angles):
	_, a = case(name, 9)
	want = np.asarray(jcurvedsky.rotate_alm(jnp.asarray(a), *angles))
	got = curvedsky.rotate_alm(torch.from_numpy(a), *angles)
	assert got.dtype == torch.complex128 and rel(got, want) < 1e-10
	if angles[1] != 0:
		back = curvedsky.rotate_alm(got, -angles[2], -angles[1], -angles[0])
		assert rel(back, a) < 1e-9


@pytest.mark.parametrize("spin", [0, 1])
def test_prof2alm_against_reference(spin):
	th = np.linspace(0, np.pi, LMAX + 2)   # CC rings: lmax LMAX
	prof = np.exp(-th**2*20)
	if spin: prof = np.stack([prof*th, 0.5*prof])
	want = np.asarray(jcurvedsky.prof2alm(prof, dir=[0.3, 0.4], spin=spin))
	got = curvedsky.prof2alm(prof, dir=[0.3, 0.4], spin=spin, device="cpu")
	assert rel(got, want) < 1e-10
	want = np.asarray(jcurvedsky.prof2alm(prof, spin=spin, norot=True))
	assert rel(curvedsky.prof2alm(prof, spin=spin, norot=True, device="cpu"), want) < 1e-12


def test_prof2alm_radial_against_reference():
	r = np.linspace(0, 0.5, 100)
	br = np.exp(-(r/0.1)**2)
	want = np.asarray(jcurvedsky.prof2alm_radial(br, r, lmax=LMAX, pos=[0.2, 1.0]))
	got = curvedsky.prof2alm_radial(br, r, lmax=LMAX, pos=[0.2, 1.0], device="cpu")
	assert got.dtype == torch.complex128 and rel(got, want) < 1e-10
	want = np.asarray(jcurvedsky.prof2alm_radial(br, r, lmax=LMAX))
	assert rel(curvedsky.prof2alm_radial(br, r, lmax=LMAX, device="cpu"), want) < 1e-12


def test_raw_general_entries():
	"""alm2map_raw_general and map2alm_raw_general (lmax and mmax from
	ainfo) against synthesis_general / adjoint_synthesis_general; the
	reference's own raise TypeError."""
	a = rand_alm(10)
	loc = rand_loc(2, 48)
	ainfo = curvedsky.alm_info(lmax=LMAX)
	with pytest.raises(TypeError):
		jcurvedsky.alm2map_raw_general(jnp.asarray(a), None, jnp.asarray(loc), ainfo=jcurvedsky.alm_info(
			lmax=LMAX))
	want = curvedsky.synthesis_general(torch.from_numpy(a), loc, lmax=LMAX)
	got = curvedsky.alm2map_raw_general(torch.from_numpy(a), None, loc, ainfo=ainfo)
	assert torch.equal(got, want)
	m = enmap.zeros((3, 6, 8), wcsutils.WCS(naxis=2), device="cpu")
	out = curvedsky.alm2map_raw_general(torch.from_numpy(a), m, loc, ainfo=ainfo)
	assert out is m and torch.equal(m.data, want.reshape(3, 6, 8))
	wts = np.random.default_rng(4).uniform(0.5, 1.5, 48)
	want = curvedsky.adjoint_synthesis_general(want*torch.from_numpy(wts), loc, lmax=LMAX)
	got = curvedsky.map2alm_raw_general(m, loc, ainfo=ainfo, weights=wts)
	assert rel(got, want) < 1e-15
	alm = torch.zeros(3, NALM, dtype=torch.complex128)
	assert curvedsky.map2alm_raw_general(m, loc, alm=alm, weights=wts) is alm
	assert rel(alm, want) < 1e-15


def test_general_positions_built_once(monkeypatch):
	"""The general branches of alm2map and map2alm take the geometry's
	pixel positions from one table per geometry and device: the host
	builds the positions once, and passing the same positions as locinfo
	gives the same map."""
	w = port_wcs(general_wcs("plain"))
	calls = []
	posmap_np = enmap._posmap_np
	monkeypatch.setattr(enmap, "_posmap_np", lambda *a, **k: calls.append(1) or posmap_np(*a, **k))
	curvedsky._general_tables_cached.cache_clear()
	a = torch.from_numpy(rand_alm(5))
	m1 = curvedsky.alm2map(a, enmap.zeros((3,) + SHAPE, w, device="cpu"))
	m2 = curvedsky.alm2map(a, enmap.zeros((3,) + SHAPE, w, device="cpu"))
	curvedsky.map2alm(m1, lmax=LMAX)
	assert len(calls) == 1
	loc = curvedsky.calc_locinfo(SHAPE, w)
	m3 = curvedsky.alm2map(a, enmap.zeros((3,) + SHAPE, w, device="cpu"), locinfo=loc)
	assert torch.equal(m1.data, m2.data) and rel(m3.data, m1.data.numpy()) < 1e-15
	curvedsky._general_tables_cached.cache_clear()


def test_general_launches_nothing_on_the_cpu():
	"""On CPU tensors the point stage runs the plain twins: no kernel
	launch is counted."""
	nufft_cuda.reset_launches()
	curvedsky.synthesis_general(torch.from_numpy(rand_alm(1)), rand_loc(2), lmax=LMAX)
	assert sum(nufft_cuda.LAUNCHES.values()) == 0
