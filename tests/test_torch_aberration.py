"""pixell_tpu_torch.aberration and .old_aberration against pixell_tpu on the
CPU, every public name, with inputs made from a numpy seed, on a 20 x 40
CAR patch at 1 degree:

- the reference's deflect loses precision near the anti-apex, where its
  arccos is ill-conditioned (cos t -> -1); this patch holds the anti-apex
  of dir_equ (ra -12.1, dec 6.9 degrees), where the reference's positions
  are off by up to 8.5e-14 rad and its angle by 1.9e-7 rad (against a
  40-digit evaluation; ROADMAP Queue 3). So the port's source positions
  and angle are held within 1e-13 (relative, rad) of a 40-digit evaluation
  of the reference's formulas, its maps within 1e-12 of the reference's
  own steps (interpolation, rotation) at those positions and angle, and
  against the reference's boost_map within 1e-10 of the largest value
  (1e-6 where the angle enters, for Q and U); deflect's angle at random
  points within 2e-8 rad of the reference's (its cancellation reaches
  1.1e-8 rad at 85 degrees) and within 1e-13 rad of the 40-digit
  evaluation; elsewhere within 1e-12;
- the components: with three, the port's rotation is the reference's; with
  four, the reference rotates components 1 and 2 where enmap.rotate_pol
  rotates the last two, so the port is held to the reference's own steps
  (its positions, interpolation and angle) with the last two, and the
  reference is asserted to differ (ROADMAP Queue 3);
- fully: the reference's always answers False (its analyse_geometry sets
  none of the attributes it reads); the port answers for the full-sky
  quadrature geometry True, for a band or a patch False;
- apply_aberration: the reference looks pixels up at remap's [ra, dec]
  rows read as [dec, ra]; the port at [dec, ra], held to the reference
  given the rows swapped;
- float32 boosts by the float32 rule (each against the float64 reference,
  the port's error within twice the reference's plus 2e-5);
- the pole rows of a Clenshaw-Curtis full sky, where the reference's angle
  is 0 (asserted) and the port's is its own limit at the pole, the other
  rows against the reference (ROADMAP Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import aberration as jab, old_aberration as jold, enmap as jenmap, interpol as jinterpol, \
	utils as jutils
from pixell_tpu_torch import aberration, old_aberration, enmap, utils

BOX = np.array([[-10, 20], [10, -20]])*np.pi/180
RES = np.pi/180
REF_TOL = 1e-10   # maps against the reference's, which is off near the anti-apex (above)
POL_TOL = 1e-6    # the same where the reference's angle enters: Q and U
ANGLE_TOL = 2e-8  # deflect's angle against the reference's at random points, radians
F32_TOL = 2e-5


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def maps(ncomp=3, seed=0, dtype=np.float64):
	jshape, jwcs = jenmap.geometry(pos=BOX, res=RES, proj="car")
	shape, wcs = enmap.geometry(pos=BOX, res=RES, proj="car")
	m = np.random.default_rng(seed).standard_normal((max(ncomp, 1),) + jshape).astype(dtype)
	if ncomp == 0: m = m[0]
	return jenmap.ndmap(m, jwcs), enmap.ndmap(torch.from_numpy(m.copy()), wcs)


def test_constants():
	assert aberration.beta == jab.beta and aberration.freq_ref == jab.freq_ref
	np.testing.assert_array_equal(aberration.dir_equ, jab.dir_equ)
	np.testing.assert_array_equal(aberration.dir_ecl, jab.dir_ecl)
	assert (utils.T_cmb, utils.c, utils.h, utils.k) == (jutils.T_cmb, jutils.c, jutils.h, jutils.k)


@pytest.mark.parametrize("kw", [dict(), dict(modulation="plain"), dict(modulation="freq", dipole=True),
	dict(modulation=None, beta=0.01), dict(aberrate=False), dict(modulate=False), dict(pol=False)],
	ids=["thermo", "plain", "freq-dipole", "config4-beta0.01", "modulate", "aberrate", "nopol"])
def test_boost_map(kw):
	jm, m = maps()
	want = jab.boost_map(jm, return_modulation=True, **kw)
	got = aberration.boost_map(m, return_modulation=True, **kw)
	assert isinstance(got[0], enmap.ndmap) and got[0].wcs == m.wcs
	tol = POL_TOL if kw.get("aberrate", True) and kw.get("pol") is not False else \
		REF_TOL if kw.get("aberrate", True) else 1e-12
	assert rel(got[0].data, want[0]) < tol
	assert (got[1] is None) == (want[1] is None)
	if want[1] is not None: assert rel(got[1].data, want[1]) < 1e-12


@pytest.mark.parametrize("name", ["aberrate_map", "deaberrate_map", "modulate_map", "demodulate_map",
	"deboost_map"])
def test_named_operations(name):
	jm, m = maps(ncomp=0, seed=1)   # one component: no polarization angle
	want = getattr(jab, name)(jm, beta=0.003)
	assert rel(getattr(aberration, name)(m, beta=0.003).data, want) < (1e-12 if "modulate" in name else REF_TOL)
	jm, m = maps(seed=1)
	want = getattr(jab, name)(jm, beta=0.003)
	assert rel(getattr(aberration, name)(m, beta=0.003).data, want) < POL_TOL
	for fun in (old_aberration.aberrate, old_aberration.deaberrate):
		ref = getattr(jold, fun.__name__)(jm, beta=0.003)
		assert rel(fun(m, beta=0.003).data, ref) < POL_TOL


def test_float32():
	jm, m = maps()
	jm32, m32 = maps(dtype=np.float32)
	want = np.asarray(jab.boost_map(jm, beta=0.01, modulation=None))
	ref32 = np.asarray(jab.boost_map(jm32, beta=0.01, modulation=None)).astype(np.float64)
	got = aberration.boost_map(m32, beta=0.01, modulation=None)
	assert got.dtype == torch.float32
	eport, eref = rel(got.data.double(), want), rel(ref32, want)
	assert eport <= 2*eref + F32_TOL, (eport, eref)


def ref_steps(jm, pix, gamma, comps):
	"""The reference's Aberrator.aberrate steps at the pixel positions pix
	and angle gamma (numpy): its interpolation, then the components comps
	rotated by 2 gamma."""
	vals = np.asarray(jinterpol.map_coordinates(jnp.asarray(np.asarray(jm)), jnp.asarray(pix), order=3,
		border="cyclic"))
	c2, s2 = np.cos(2*gamma), np.sin(2*gamma)
	want = vals.copy()
	want[comps[0]], want[comps[1]] = c2*vals[comps[0]] - s2*vals[comps[1]], s2*vals[comps[0]] + c2*vals[comps[1]]
	return want


def test_operators():
	jm, m = maps()
	ja = jab.Aberrator(jm.shape, jm.wcs, beta=0.01)
	a = aberration.Aberrator(m.shape, m.wcs, beta=0.01, device="cpu")
	# the source positions and angle against 40 digits, at pixels near the
	# anti-apex and spread over the patch
	dec, ra = enmap._posmap_np(m.shape, m.wcs).reshape(2, -1)
	near = np.argsort(np.abs(dec - (-aberration.dir_equ[1])) + np.abs(ra - (aberration.dir_equ[0] - np.pi)))
	idx = np.concatenate([near[:20], np.arange(0, dec.size, 41)])
	exact = deflect_exact(dec[idx], ra[idx], aberration.dir_equ, -0.01, angle=False)
	assert rel(a.ipos.numpy()[:, idx], exact) < 1e-13
	exact = deflect_exact(dec[idx], ra[idx], aberration.dir_equ, -0.01)
	assert np.abs(a.gamma.numpy().reshape(-1)[idx] - exact).max() < 1e-13
	assert rel(a.ipos, ja.ipos) < 1e-12
	assert np.abs(a.gamma.numpy() - ja.gamma).max() < 1e-6   # radians
	want = ref_steps(jm, a._pix.numpy(), a.gamma.numpy(), (1, 2))
	assert rel(a(m).data, want) < 1e-12 and rel(a.aberrate(m).data, want) < 1e-12
	assert rel(a(m).data, ja(jm)) < POL_TOL
	jmod = jab.Modulator(jm.shape, jm.wcs, beta=0.01, dipole=True)
	mod = aberration.Modulator(m.shape, m.wcs, beta=0.01, dipole=True, device="cpu")
	assert rel(mod.A.data, jmod.A) < 1e-12
	assert rel(mod(m).data, jmod(jm)) < 1e-12
	assert rel(mod.modulate(m).data, jmod.modulate(jm)) < 1e-12


def test_components():
	"""Three components: the reference's rotation. Four: the last two
	rotated, where the reference rotates components 1 and 2."""
	jm, m = maps(ncomp=4, seed=2)
	ja = jab.Aberrator(jm.shape, jm.wcs, beta=0.01)
	a = aberration.Aberrator(m.shape, m.wcs, beta=0.01, device="cpu")
	got = a.aberrate(m).data.numpy()
	assert rel(got, ref_steps(jm, a._pix.numpy(), a.gamma.numpy(), (-2, -1))) < 1e-12
	assert rel(got, ref_steps(jm, ja._pix_host, ja.gamma, (-2, -1))) < POL_TOL
	assert rel(np.asarray(ja.aberrate(jm)), ref_steps(jm, ja._pix_host, ja.gamma, (-2, -1))) > 1e-3
	jm3, m3 = jenmap.ndmap(np.asarray(jm)[:3], jm.wcs), enmap.ndmap(m.data[:3], m.wcs)
	assert rel(a.aberrate(m3).data, ref_steps(jm3, a._pix.numpy(), a.gamma.numpy(), (1, 2))) < 1e-12
	assert rel(a.aberrate(m3).data, ja.aberrate(jm3)) < POL_TOL


def deflect_exact(dec, ra, dir, beta, offset=5e-7, angle=True):
	"""deflect's angle at 40 digits (mpmath): the reference's finite offset
	of transform_meta, on the closed-form deflected vector (which is the
	reference's arccos and rotation written out); with angle=False the
	deflected [dec, ra]."""
	import mpmath as mp
	from pixell_tpu_torch import coordinates
	mp.mp.dps = 40
	R = coordinates.euler_mat(coordinates._recenter_angles(dir))
	Rb = coordinates.euler_mat(coordinates._decenter_angles(dir))
	def defl(d, r):
		v = [mp.cos(d)*mp.cos(r), mp.cos(d)*mp.sin(r), mp.sin(d)]
		x, y, z = [sum(mp.mpf(R[i, j])*v[j] for j in range(3)) for i in range(3)]
		sb, den = mp.sqrt(1 - mp.mpf(beta)**2), 1 + beta*z
		w = [x*sb/den, y*sb/den, (z + beta)/den]
		u = [sum(mp.mpf(Rb[i, j])*w[j] for j in range(3)) for i in range(3)]
		return mp.atan2(u[2], mp.sqrt(u[0]**2 + u[1]**2)), mp.atan2(u[1], u[0])
	out = []
	for d, r in zip(dec, ra):
		d0, r0 = defl(mp.mpf(d), mp.mpf(r))
		if not angle:
			out.append([float(d0), float(r0)])
			continue
		d1, r1 = defl(mp.mpf(d), mp.mpf(r) + mp.mpf(offset))
		dra = r1 - r0
		out.append(float(mp.atan2(d1 - d0, (dra - 2*mp.pi*mp.nint(dra/(2*mp.pi)))*mp.cos(d0))))
	return np.array(out) if angle else np.array(out).T


def test_deflect():
	"""Positions within 1e-12 of the reference. The angle: the reference
	subtracts two positions 5e-7 rad apart and is off by up to 1.1e-8 rad
	at dec 85 degrees (against a 40-digit evaluation of the same
	difference), so it is held within 2e-8 rad there; the port, which takes
	the difference without cancellation, within 1e-13 rad of the 40-digit
	evaluation."""
	rng = np.random.default_rng(3)
	dec, ra = rng.uniform(-1.5, 1.5, 300), rng.uniform(-4, 8, 300)
	want = jab.deflect(dec, ra, jab.dir_ecl, 0.01, return_rot=True)
	exact = deflect_exact(dec[:40], ra[:40], aberration.dir_ecl, 0.01)
	for arg in (lambda x: x, torch.from_numpy):
		got = aberration.deflect(arg(dec), arg(ra), aberration.dir_ecl, 0.01, return_rot=True)
		assert rel(got[0], want[0]) < 1e-12 and rel(got[1], want[1]) < 1e-12
		assert np.abs(np.asarray(got[2]) - want[2]).max() < ANGLE_TOL   # radians
		assert np.abs(np.asarray(got[2])[:40] - exact).max() < 1e-13
		got = aberration.deflect(arg(dec), arg(ra), aberration.dir_ecl, -0.01)
		want2 = jab.deflect(dec, ra, jab.dir_ecl, -0.01)
		assert rel(got[0], want2[0]) < 1e-12 and rel(got[1], want2[1]) < 1e-12


def test_helpers():
	z = np.linspace(-1, 1, 41)
	for b in (0.01, -0.3):
		for g, w in zip(aberration.calc_boost_1d(z, b), jab.calc_boost_1d(z, b)): assert rel(g, w) < 1e-12
	assert aberration.beta2lmax(0.01, 1000) == jab.beta2lmax(0.01, 1000)
	rng = np.random.default_rng(4)
	g, q, u = rng.standard_normal((3, 5, 6))
	for spin in (0, 1, 2):
		want = jab.rotate_pol(np.array([q, u]), g, spin=spin)
		assert rel(aberration.rotate_pol(torch.from_numpy(np.array([q, u])), torch.from_numpy(g), spin=spin),
			want) < 1e-12
		wl = jab.rotate_pol([q, u], g, spin=spin)
		gl = aberration.rotate_pol([torch.from_numpy(q), torch.from_numpy(u)], torch.from_numpy(g), spin=spin)
		assert isinstance(gl, list) and all(rel(a, b) < 1e-12 for a, b in zip(gl, wl))
	x = rng.uniform(-10, 20, 50)
	want = jab.fast_rewind(x.copy(), 2*np.pi)
	got = torch.from_numpy(x.copy())
	assert aberration.fast_rewind(got, 2*np.pi) is got and rel(got, want) < 1e-12
	assert rel(aberration.fast_rewind(x.copy(), 3.0, ref=1.0), jab.fast_rewind(x.copy(), 3.0, ref=1.0)) < 1e-12


def test_sky2pix():
	jm, m = maps()
	rng = np.random.default_rng(5)
	pos = np.array([rng.uniform(-0.2, 0.2, 30), rng.uniform(-0.4, 0.4, 30)])
	want = jab.sky2pix(jm.shape, jm.wcs, pos)
	assert rel(aberration.sky2pix(m.shape, m.wcs, pos), want) < 1e-12
	assert rel(aberration.sky2pix(m.shape, m.wcs, torch.from_numpy(pos)), want) < 1e-12
	cshape, cwcs = enmap.geometry(pos=BOX, res=RES, proj="cea")
	jshape, jwcs = jenmap.geometry(pos=BOX, res=RES, proj="cea")
	assert rel(aberration.sky2pix(cshape, cwcs, pos), jab.sky2pix(jshape, jwcs, pos)) < 1e-12


@pytest.mark.parametrize("mode", [None, "none", "plain", "T2T", "T2lin", "lin2T", "lin2lin"])
def test_apply_modulation(mode):
	jm, m = maps(seed=6)
	A = 1 + 1e-3*np.random.default_rng(7).standard_normal(jm.shape[-2:])
	for dipole in (False, True):
		for jx, x in ((jm, m), (jm[0], m[0])):
			want = jab.apply_modulation(jx, A, mode=mode, dipole=dipole)
			got = aberration.apply_modulation(x, torch.from_numpy(A), mode=mode, dipole=dipole)
			assert rel(got.data if isinstance(got, enmap.ndmap) else got, want) < 1e-12
	with pytest.raises(ValueError):
		aberration.apply_modulation(m, torch.from_numpy(A), mode="thermo")


def test_fully():
	full = enmap.fullsky_geometry(res=10*utils.degree, variant="fejer1")
	jfull = jenmap.fullsky_geometry(res=10*utils.degree, variant="fejer1")
	band = enmap.band_geometry(60*utils.degree, res=10*utils.degree)
	jband = jenmap.band_geometry(60*utils.degree, res=10*utils.degree)
	assert aberration.fully(*full) and not jab.fully(*jfull)
	assert not aberration.fully(*band) and not jab.fully(*jband)
	patch = enmap.geometry(pos=BOX, res=RES, proj="car")
	assert not aberration.fully(*patch) and not jab.fully(*jenmap.geometry(pos=BOX, res=RES, proj="car"))


def test_calc_boost_field():
	dir = np.array([0.3, 0.2])
	want = jab.calc_boost_field(0.01, dir, lmax=12, modulation=True, mod_exp=2)
	got = aberration.calc_boost_field(0.01, dir, lmax=12, modulation=True, mod_exp=2, device="cpu")
	assert rel(got[0], want[0]) < 1e-12 and rel(got[1], want[1]) < 1e-12
	assert rel(aberration.calc_boost_field(0.01, dir, lmax=12, device="cpu"), want[0]) < 1e-12


@pytest.mark.parametrize("ydouble", [False, True])
def test_interpol_map(ydouble):
	jm, m = maps(seed=8)
	rng = np.random.default_rng(9)
	pixs = np.array([rng.uniform(-2, 22, 50), rng.uniform(-2, 42, 50)])
	want = jab.interpol_map(np.asarray(jm), pixs, ydouble=ydouble)
	assert rel(aberration.interpol_map(m.data, torch.from_numpy(pixs), ydouble=ydouble), want) < 1e-12


def test_old_helpers():
	rng = np.random.default_rng(10)
	th = rng.uniform(0, np.pi, 50)
	for name in ("aber_angle", "mod_amplitude", "aber_deriv"):
		want = getattr(jold, name)(th, 0.01)
		assert rel(getattr(old_aberration, name)(th, 0.01), want) < 1e-12
		assert rel(getattr(old_aberration, name)(torch.from_numpy(th), 0.01), want) < 1e-12
	T = 2.7 + 0.01*rng.standard_normal(20)
	for deriv in (False, True):
		assert rel(old_aberration.planck(150e9, T, deriv=deriv), jold.planck(150e9, T, deriv=deriv)) < 1e-12
	I = jold.planck(150e9, T)
	assert rel(old_aberration.inv_planck(150e9, I), jold.inv_planck(150e9, I)) < 1e-12
	assert rel(old_aberration.inv_planck(150e9, torch.from_numpy(I)), T) < 1e-12


@pytest.mark.parametrize("name,kw", [("remap", dict()), ("remap", dict(pol=False, modulation=False)),
	("remap", dict(recenter=True)), ("calc_boost", dict()), ("distortion", dict())])
def test_remap(name, kw):
	rng = np.random.default_rng(11)
	pos = np.array([rng.uniform(0, 6, 60), rng.uniform(-1.4, 1.4, 60)])
	dir = np.array([1.0, 0.4])
	want = np.asarray(getattr(jold, name)(pos, dir, 0.01, **kw))
	angle_row = name != "distortion" and kw.get("pol", True)
	for arg in (lambda x: x, torch.from_numpy):
		got = np.asarray(getattr(old_aberration, name)(arg(pos), dir, 0.01, **kw))
		if angle_row:
			# remap's angle is coordinates.transform's finite offset, as the
			# reference's: 1e-8 rad, as test_torch_coordinates.py holds that angle
			assert rel(got[:2], want[:2]) < 1e-12
			assert np.abs(got[2] - want[2]).max() < 1e-8
		else:
			assert rel(got, want) < 1e-12


def test_apply_aberration():
	jm, m = maps(seed=12)
	dec, ra = enmap._posmap_np(m.shape, m.wcs)
	pos = np.array([ra.reshape(-1), dec.reshape(-1)])
	ipos = np.asarray(jold.remap(pos, aberration.dir_equ, 0.01, modulation=False))   # [ra, dec, angle]
	swapped = ipos[[1, 0, 2]]
	want = np.asarray(jold.apply_aberration(jm, swapped))
	got = old_aberration.apply_aberration(m, ipos)
	assert rel(got.data, want) < 1e-12
	assert rel(np.asarray(jold.apply_aberration(jm, ipos)), want) > 1e-3


@pytest.mark.parametrize("beta", [0.01, 0.001235])
def test_pole_rows(beta):
	"""IQU on the Clenshaw-Curtis full sky at 5 degrees (37 x 72), whose
	first and last rows lie on the poles (ROADMAP Queue 3): the reference
	takes deflect's angle by a finite offset of 5e-7 rad in RA, whose two
	points coincide on a pole row, so its angle is 0 there at every RA
	(asserted); the port's closed form gives the limit along the pixel's
	meridian, held within 1e-6 rad of its own angle 1e-9 rad from the pole
	(~1e2 times that distance measured). The other rows within POL_TOL of
	the reference's boost_map."""
	jshape, jwcs = jenmap.fullsky_geometry(res=5*jutils.degree, variant="CC")
	shape, wcs = enmap.fullsky_geometry(res=5*utils.degree, variant="CC")
	m = np.random.default_rng(9).standard_normal((3,) + tuple(jshape))
	want = np.asarray(jab.boost_map(jenmap.ndmap(m, jwcs), beta=beta, modulation=None))
	got = aberration.boost_map(enmap.ndmap(torch.from_numpy(m.copy()), wcs), beta=beta, modulation=None)
	assert rel(got.data[..., 1:-1, :], want[..., 1:-1, :]) < POL_TOL
	pos = np.asarray(jenmap.posmap(jshape, jwcs))
	dec, ra = pos[0][[0, -1]], pos[1][[0, -1]]
	assert np.all(np.abs(np.abs(dec) - np.pi/2) < 1e-12)
	assert np.all(np.asarray(jab.deflect(dec, ra, jab.dir_equ, beta, return_rot=True)[2]) == 0)
	ang = np.asarray(aberration.deflect(dec, ra, aberration.dir_equ, beta, return_rot=True)[2])
	near = np.sign(dec)*(np.pi/2 - 1e-9)
	ang_near = np.asarray(aberration.deflect(near, ra, aberration.dir_equ, beta, return_rot=True)[2])
	assert np.abs(jutils.rewind(ang - ang_near)).max() <= 1e-6
	assert np.abs(jutils.rewind(ang)).max() > 1e-3   # not the reference's 0
