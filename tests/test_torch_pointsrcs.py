"""pixell_tpu_torch.pointsrcs against pixell_tpu.pointsrcs on the CPU, with
inputs made from a numpy seed, float64 unless stated:

- sim_objects with op add / max / min on [3, nobj] amplitudes, with pixwin,
  on a full-sky map with objects across RA = 180 (the cells wrap), on a CEA
  map painted through the non-separable path and on a TAN map (not
  separable by itself), with two profiles and prof_ids, into a given omap
  (left as it was), and in float32; each within 1e-12 of the largest
  reference value (float32: 1e-6);
- its adjoint (transpose=True, with and without pixwin) against the
  reference within 1e-12, and by a dot test <paint(a), m> = <a,
  paint^T(m)> within 1e-12;
- the cell assignment against the reference's, exactly; the paint with
  small cell chunks (PAINT_CHUNK) equal to the paint in one (the adjoint
  within 1e-15: its sums per object add up in another order);
- radial_sum and radial_bin: exactly on an integer-valued map (the sums of
  integers do not depend on their order), within 1e-12 on a random one,
  and with small object batches (RADIAL_CHUNK) equal to one batch;
  radial_bin of a map with components against the reference's sums (its
  own radial_bin divides [nobj, ncomp, nbin] by [nobj, nbin] and raises
  ValueError; asserted);
- cellify / uncellify against the reference and round trips, exactly;
- utils.crossmatch (both modes) the same pairs as the reference's, and
  pointsrcs.crossmatch the same pairs on [ra, dec] catalogues (the
  reference's passes tol= to utils.crossmatch, which takes rmax, and raises
  TypeError; the test asserts it);
- sim_srcs, sim_srcs_python (the reference's passes verbose= on and raises
  TypeError; asserted), expand_beam, nsigma2rmax, build_src_cells and its
  helper, eval_srcs_loop, src2param, translate_dtype_keys;
- the text and HDF catalogues (read / write_simple, read_hdf_cat, read_nemo,
  read_dory_txt, the sauron text format) against the reference's readers;
- the FITS catalogue functions (read with a FITS file, read_fits_cat,
  write_fits_cat, read_dory_fits, read_fits, the sauron FITS pair) against
  the reference's readers of the same file; sim_srcs_dist_transform against
  the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import pointsrcs as jpointsrcs, enmap as jenmap, utils as jutils, bunch as jbunch
from pixell_tpu_torch import pointsrcs, enmap, utils, bunch

TOL = 1e-12


def host(x):
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().numpy()
	return np.asarray(x)


def rel(got, want):
	got, want = host(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def patch(mod, proj="car"):
	if proj == "tan":   # a zenithal projection is given by its centre
		return mod.geometry(pos=np.array([0.0, 0.0]), shape=(64, 64), res=0.125*utils.degree, proj=proj)
	return mod.geometry(pos=np.array([[-4, 4], [4, -4]])*utils.degree, res=0.125*utils.degree, proj=proj)


def fullsky(mod):
	return mod.fullsky_geometry(res=3*utils.degree)


def objects(n=40, seed=0, spread=0.06, center=(0.0, 0.0), ncomp=3):
	rng = np.random.default_rng(seed)
	poss = np.array([rng.uniform(-spread, spread, n) + center[0], rng.uniform(-spread, spread, n) + center[1]])
	amps = rng.uniform(-1, 2, (ncomp, n)) if ncomp else rng.uniform(0.5, 2, n)
	return poss, amps


def profile(sigma=0.3*utils.degree, rmax=1.5*utils.degree, n=400):
	r = np.linspace(0, rmax, n)
	return r, np.exp(-0.5*(r/sigma)**2)


def paint_pair(geo, poss, amps, prof, **kw):
	(js, jw), (ps, pw) = geo(jenmap), geo(enmap)
	dtype = kw.pop("dtype", np.float64)
	j = jpointsrcs.sim_objects(js, jw, poss, amps, prof, dtype=dtype, **kw)
	p = pointsrcs.sim_objects(ps, pw, poss, amps, prof, dtype=dtype, device="cpu", **kw)
	return np.asarray(j), p


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("pixwin", [False, True])
def test_sim_objects(op, pixwin):
	poss, amps = objects()
	j, p = paint_pair(patch, poss, amps, profile(), op=op, pixwin=pixwin)
	assert p.shape == (3,) + tuple(patch(enmap)[0]) and rel(p, j) <= TOL
	assert np.abs(j).max() > 0.5


def test_sim_objects_geometries():
	# the full sky, objects across RA = 180: the cells wrap
	poss, amps = objects(20, 1, 0.1, (0.3, np.pi - 0.05), ncomp=0)
	j, p = paint_pair(fullsky, poss, amps, profile(4*utils.degree, 20*utils.degree))
	assert rel(p, j) <= TOL and np.abs(j[:, :2]).max() > 0.1 and np.abs(j[:, -2:]).max() > 0.1
	# CEA through the non-separable path; TAN, which is not separable
	poss, amps = objects(30, 2)
	for geo, kw in [(lambda m: patch(m, "cea"), dict(separable=False)), (lambda m: patch(m, "tan"), {})]:
		j, p = paint_pair(geo, poss, amps, profile(), **kw)
		assert rel(p, j) <= TOL
	# two profiles chosen by prof_ids, and a vmin and an rmax
	ids = np.arange(poss.shape[1]) % 2
	profs = [np.array(profile()), np.array(profile(0.6*utils.degree, 2*utils.degree))]
	j, p = paint_pair(patch, poss, amps, profs, prof_ids=ids, vmin=1e-4, rmax=1.2*utils.degree)
	assert rel(p, j) <= TOL
	# float32
	j, p = paint_pair(patch, poss, amps, profile(), dtype=np.float32)
	assert p.dtype == torch.float32 and rel(p, j) <= 1e-6


def test_sim_objects_omap():
	poss, amps = objects()
	(js, jw), (ps, pw) = patch(jenmap), patch(enmap)
	base = np.random.default_rng(7).standard_normal((3,) + tuple(js[-2:]))
	om = enmap.ndmap(torch.from_numpy(base.copy()), pw)
	p = pointsrcs.sim_objects(ps, pw, poss, amps, profile(), omap=om, dtype=np.float64)
	j = jpointsrcs.sim_objects(js, jw, poss, amps, profile(), omap=jenmap.ndmap(base, jw), dtype=np.float64)
	assert rel(p, j) <= TOL and np.array_equal(om.data.numpy(), base)


def test_cells_and_chunks(monkeypatch):
	poss, amps = objects()
	(ps, pw) = patch(enmap)
	pix = np.round(np.asarray(enmap.sky2pix(ps, pw, poss))).astype(np.int32)
	R = np.full(poss.shape[1], 9)
	for wrap in (False, True):
		a = pointsrcs._build_cells(pix, R, R + 3, ps[-2], ps[-1], 16, wrap)
		b = jpointsrcs._build_cells(pix, R, R + 3, ps[-2], ps[-1], 16, wrap)
		assert all(np.array_equal(x, y) for x, y in zip(a, b))
	one = pointsrcs.sim_objects(ps, pw, poss, amps, profile(), dtype=np.float64, device="cpu")
	m = torch.from_numpy(np.random.default_rng(8).standard_normal(one.shape))
	adj = pointsrcs.sim_objects(ps, pw, poss, amps, profile(), dtype=np.float64, transpose=True,
		omap=enmap.ndmap(m, pw))
	monkeypatch.setattr(pointsrcs, "PAINT_CHUNK", 3*pointsrcs.CSIZE**2)
	assert torch.equal(pointsrcs.sim_objects(ps, pw, poss, amps, profile(), dtype=np.float64, device="cpu").data,
		one.data)
	# the adjoint's per-object sums add up in another order
	assert rel(pointsrcs.sim_objects(ps, pw, poss, amps, profile(), dtype=np.float64, transpose=True,
		omap=enmap.ndmap(m, pw)), host(adj)) <= 1e-15


@pytest.mark.parametrize("pixwin", [False, True])
def test_transpose(pixwin):
	poss, amps = objects()
	(js, jw), (ps, pw) = patch(jenmap), patch(enmap)
	m = np.random.default_rng(9).standard_normal((3,) + tuple(js[-2:]))
	j = jpointsrcs.sim_objects(js, jw, poss, amps, profile(), omap=jenmap.ndmap(m, jw), transpose=True,
		pixwin=pixwin, dtype=np.float64)
	p = pointsrcs.sim_objects(ps, pw, poss, amps, profile(), omap=enmap.ndmap(torch.from_numpy(m), pw),
		transpose=True, pixwin=pixwin, dtype=np.float64)
	assert p.shape == amps.shape and rel(p, j) <= TOL
	fwd = pointsrcs.sim_objects(ps, pw, poss, amps, profile(), pixwin=pixwin, dtype=np.float64, device="cpu")
	lhs, rhs = float(np.sum(host(fwd)*m)), float(np.sum(host(p)*amps))
	assert abs(lhs - rhs) <= TOL*abs(lhs)


def test_radial(monkeypatch):
	poss, _ = objects(12, 3, 0.04)
	(js, jw), (ps, pw) = patch(jenmap), patch(enmap)
	bins = np.linspace(0, 0.8*utils.degree, 9)
	rng = np.random.default_rng(10)
	for d, tol in [(rng.integers(-50, 50, (3,) + tuple(js[-2:])).astype(float), 0),
			(rng.standard_normal((3,) + tuple(js[-2:])), TOL)]:
		pm = enmap.ndmap(torch.from_numpy(d), pw)
		j = jpointsrcs.radial_sum(jenmap.ndmap(d, jw), poss, bins)
		p = pointsrcs.radial_sum(pm, poss, bins)
		assert rel(p, j) <= tol
		jd = jenmap.ndmap(d[0], jw)
		assert rel(pointsrcs.radial_bin(pm[0], poss, bins), jpointsrcs.radial_bin(jd, poss, bins)) <= max(tol, 1e-15)
		# with components the reference divides [nobj, 3, nbin] by [nobj, nbin] and raises
		with pytest.raises(ValueError):
			jpointsrcs.radial_bin(jenmap.ndmap(d, jw), poss, bins)
		want = np.asarray(jpointsrcs.radial_sum(jenmap.ndmap(d, jw), poss, bins))/np.maximum(
			np.asarray(jpointsrcs.radial_sum(jenmap.ndmap(np.ones(d.shape[-2:]), jw), poss, bins)), 1)[:, None]
		assert rel(pointsrcs.radial_bin(pm, poss, bins), want) <= max(tol, 1e-15)
	monkeypatch.setattr(pointsrcs, "RADIAL_CHUNK", 1)
	assert torch.equal(pointsrcs.radial_sum(pm, poss, bins), p)
	# a full-sky map with objects across RA = 180
	(js, jw), (ps, pw) = fullsky(jenmap), fullsky(enmap)
	d = rng.integers(-50, 50, tuple(js[-2:])).astype(float)
	poss = np.array([[0.2, -0.5], [np.pi - 0.01, -np.pi + 0.02]])
	bins = np.linspace(0, 12*utils.degree, 5)
	assert rel(pointsrcs.radial_sum(enmap.ndmap(torch.from_numpy(d), pw), poss, bins),
		jpointsrcs.radial_sum(jenmap.ndmap(d, jw), poss, bins)) == 0


def test_cellify():
	d = np.random.default_rng(11).standard_normal((3, 37, 50))
	j = jpointsrcs.cellify(d, (8, 10))
	p = pointsrcs.cellify(torch.from_numpy(d), (8, 10))
	assert isinstance(p, torch.Tensor) and rel(p, j) == 0
	assert rel(pointsrcs.cellify(d, (8, 10)), j) == 0
	assert rel(pointsrcs.uncellify(p), jpointsrcs.uncellify(j)) == 0
	assert np.array_equal(host(pointsrcs.uncellify(p)), d[:, :32, :50])


def test_crossmatch():
	rng = np.random.default_rng(12)
	ra, dec = rng.uniform(0, 0.2, 30), rng.uniform(-0.1, 0.1, 30)
	cat1 = np.array([ra, dec]).T
	cat2 = np.array([ra + rng.normal(0, 1e-4, 30), dec + rng.normal(0, 1e-4, 30)]).T[::-1]
	tol = 3e-4
	for mode in ("closest", "all"):
		want = jutils.crossmatch(cat1[:, ::-1], cat2[:, ::-1], tol, mode=mode)
		assert utils.crossmatch(cat1[:, ::-1], cat2[:, ::-1], tol, mode=mode) == want
	assert pointsrcs.crossmatch(cat1, cat2, tol=tol) == jutils.crossmatch(cat1[:, ::-1], cat2[:, ::-1], tol)
	assert len(pointsrcs.crossmatch(cat1, cat2, tol=tol)) > 20
	with pytest.raises(TypeError):
		jpointsrcs.crossmatch(cat1, cat2, tol=tol)


def test_legacy_and_helpers():
	(js, jw), (ps, pw) = patch(jenmap), patch(enmap)
	srcs = np.array([[0.01, 0.02, 3.0], [-0.02, 0.0, 1.5]])
	j = jpointsrcs.sim_srcs(js, jw, srcs, 0.3*utils.degree, dtype=np.float64)
	p = pointsrcs.sim_srcs(ps, pw, srcs, 0.3*utils.degree, dtype=np.float64, device="cpu")
	assert rel(p, j) <= TOL
	assert rel(pointsrcs.sim_srcs_python(ps, pw, srcs, 0.3*utils.degree, dtype=np.float64, device="cpu"), j) <= TOL
	with pytest.raises(TypeError):
		jpointsrcs.sim_srcs_python(js, jw, srcs, 0.3*utils.degree, dtype=np.float64)
	for beam in (0.01, np.linspace(1, 0, 30), np.array(profile()).T):
		assert rel(pointsrcs.expand_beam(beam), jpointsrcs.expand_beam(beam)) == 0
	assert pointsrcs.nsigma2rmax(1.0) == jpointsrcs.nsigma2rmax(1.0)
	assert pointsrcs.is_equi(profile()[0]) and not pointsrcs.is_equi(profile()[0]**2)
	cbox = np.array([[-0.1, -0.1], [0.1, 0.1]])
	pos = np.random.default_rng(13).uniform(-0.1, 0.1, (25, 2))
	for wrap in (None, [0, 0.2]):
		a, b = pointsrcs.build_src_cells(cbox, pos, 0.03, wrap=wrap), jpointsrcs.build_src_cells(cbox, pos, 0.03,
			wrap=wrap)
		assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
	assert np.array_equal(pointsrcs.build_src_cells_helper(cbox, None, 0.03, pos),
		jpointsrcs.build_src_cells_helper(cbox, None, 0.03, pos))
	pm = np.asarray(jenmap.posmap(js, jw))
	args = (pm, srcs[:, :2], srcs[:, 2], profile(), None, None, None)
	assert rel(pointsrcs.eval_srcs_loop(*args), jpointsrcs.eval_srcs_loop(*args)) <= TOL
	cat = bunch.Bunch(ra=np.array([0.1, 0.2]), dec=np.array([0.0, -0.1]), I=np.array([1.0, 2.0]), Q=np.ones(2))
	jcat = jbunch.Bunch(ra=cat.ra, dec=cat.dec, I=cat.I, Q=cat.Q)
	assert np.array_equal(pointsrcs.src2param(cat), jpointsrcs.src2param(jcat))
	rec = np.zeros(3, [("RADeg", "d"), ("x", "i")])
	assert pointsrcs.translate_dtype_keys(rec, {"RADeg": "ra"}).dtype == \
		jpointsrcs.translate_dtype_keys(rec, {"RADeg": "ra"}).dtype


def same_cat(a, b):
	for k in b.keys() if hasattr(b, "keys") else b.dtype.names:
		assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_catalogues(tmp_path):
	cat = bunch.Bunch(ra=np.array([10.0, 20.5])*utils.degree, dec=np.array([-5.0, 3.25])*utils.degree,
		I=np.array([1.5, 2.0]), Q=np.array([0.1, 0.2]))
	f = str(tmp_path/"cat.txt")
	pointsrcs.write_simple(f, cat)
	same_cat(pointsrcs.read(f), jpointsrcs.read_simple(f))
	h = str(tmp_path/"cat.hdf")
	bunch.write(h, cat)
	same_cat(pointsrcs.read(h), jpointsrcs.read_hdf_cat(h))
	n = tmp_path/"nemo.txt"
	n.write_text("ACT-S J001 10.5 -3.25 6.5 12 0.9 t1 -50.0 120.0 10.0\n"
		"ACT-S J002 11.0 -4.00 5.0 8 0.8 t2 -51.0 80.0 9.0\n")
	same_cat(pointsrcs.read_nemo(str(n)), jpointsrcs.read_nemo(str(n)))
	d = tmp_path/"dory.txt"
	d.write_text("10.0 -3.0 0 1.0 0 2.0 0 3.0\n11.0 -4.0 0 1.5 0 2.5 0 3.5\n")
	same_cat(pointsrcs.read_dory_txt(str(d)), jpointsrcs.read_dory_txt(str(d)))
	s = np.zeros(2, [("ra", "d"), ("dec", "d"), ("snr", "d", (3,)), ("flux_tot", "d", (3,)), ("dflux_tot", "d", (3,)),
		("flux", "d", (2, 3)), ("dflux", "d", (2, 3)), ("case", "i"), ("contam", "d", (2,))]).view(np.recarray)
	rng = np.random.default_rng(14)
	for k in ("snr", "flux_tot", "dflux_tot", "flux", "dflux", "contam"): s[k] = rng.uniform(0, 5, s[k].shape)
	s.ra, s.dec = [0.1, 0.2], [-0.1, 0.05]
	assert pointsrcs.format_sauron(s) == jpointsrcs.format_sauron(s)
	t = str(tmp_path/"sauron.txt")
	pointsrcs.write_sauron(t, s)
	same_cat(pointsrcs.read_sauron(t), jpointsrcs.read_sauron_txt(t))


def fits_cat(f):
	cat = bunch.Bunch(ra=np.array([10.0, 20.5, 359.0])*utils.degree, dec=np.array([-5.0, 3.25, 60.0])*utils.degree,
		I=np.array([1.5, 2.0, 0.5]), Q=np.array([0.1, 0.2, 0.3]))
	pointsrcs.write_fits_cat(f, cat)
	return cat


def sauron_cat():
	s = np.zeros(2, [("ra", "d"), ("dec", "d"), ("snr", "d", (3,)), ("flux", "d", (2, 3)), ("case", "i")])
	s = s.view(np.recarray)
	s.ra, s.dec = [0.1, 0.2], [-0.1, 0.05]
	s.snr, s.flux, s.case = np.arange(6.0).reshape(2, 3), np.arange(12.0).reshape(2, 2, 3), [1, 2]
	return s


def read_any(f):
	fits_cat(f)
	same_cat(pointsrcs.read(f), jpointsrcs.read(f))

def read_fits_cat(f):
	fits_cat(f)
	same_cat(pointsrcs.read_fits_cat(f, format="fits"), jpointsrcs.read_fits_cat(f, format="fits"))

def write_fits_cat(f):
	jpointsrcs.write_fits_cat(f + ".ref", fits_cat(f))
	assert open(f, "rb").read() == open(f + ".ref", "rb").read()

def read_dory_fits(f):
	from pixell_tpu_torch import fits_io
	fits_io.write_table_fits(f, {"ra": np.array([10.0, 20.5]), "dec": np.array([-5.0, 3.25]),
		"amp": np.array([[1.0, 0.1, 0.2], [2.0, 0.3, 0.4]])})
	same_cat(pointsrcs.read_dory_fits(f), jpointsrcs.read_dory_fits(f))

def read_fits(f):
	"""(the reference's read_fits raises ValueError on every table: Queue 3)"""
	from pixell_tpu_torch import fits_io
	cols = {"RADeg": np.array([10.0, 20.5]), "decDeg": np.array([-5.0, 3.25]),
		"deltaT_c": np.array([-100.0, -250.0]), "err_deltaT_c": np.array([10.0, 12.0])}
	fits_io.write_table_fits(f, cols)
	rec = pointsrcs.read_fits(f)
	same_cat(rec, dict(zip(("ra", "dec", "I", "dI"), cols.values())))
	with pytest.raises(ValueError): jpointsrcs.read_fits(f)

def write_sauron(f):
	pointsrcs.write_sauron(f, sauron_cat())
	jpointsrcs.write_sauron_fits(f + ".ref", sauron_cat())
	assert open(f, "rb").read() == open(f + ".ref", "rb").read()
	same_cat(pointsrcs.read_sauron_fits(f), jpointsrcs.read_sauron_fits(f))

def read_sauron(f):
	jpointsrcs.write_sauron_fits(f, sauron_cat())
	got = pointsrcs.read_sauron(f)
	same_cat(got, jpointsrcs.read_sauron(f))
	assert np.abs(got.ra - sauron_cat().ra).max() < 1e-16 and np.array_equal(got.flux, sauron_cat().flux)


@pytest.mark.parametrize("call", [read_any, read_fits_cat, write_fits_cat, read_dory_fits, read_fits, write_sauron,
	read_sauron])
def test_fits_raises(call, tmp_path):
	"""The FITS catalogues, once NotImplementedError (the test keeps its
	name and its cases): each written by one side and read by the port and
	by the reference to the same catalogue, the port's bytes the
	reference's."""
	call(str(tmp_path/"cat.fits"))


def test_dist_transform_raises():
	"""sim_srcs_dist_transform, once NotImplementedError, against the
	reference (the name is the earlier test's): 40 sources (the brute force,
	K14's plain version), into an omap, float64 and float32."""
	ps, pw = patch(enmap)
	poss, amps = objects(ncomp=0)
	srcs = np.array([poss[0], poss[1], amps]).T
	for dtype, tol in ((np.float64, TOL), (np.float32, 1e-6)):
		want = jpointsrcs.sim_srcs_dist_transform(ps, pw, srcs, 0.3*utils.degree, dtype=dtype, smul=1.5)
		got = pointsrcs.sim_srcs_dist_transform(ps, pw, srcs, 0.3*utils.degree, dtype=dtype, smul=1.5, device="cpu")
		assert got.dtype == enmap._torch_dtype(dtype) and rel(got, want) <= tol
	om = np.random.default_rng(3).standard_normal(ps)
	want = jpointsrcs.sim_srcs_dist_transform(ps, pw, srcs, 0.3*utils.degree, omap=jenmap.enmap(om, pw))
	got = pointsrcs.sim_srcs_dist_transform(ps, pw, srcs, 0.3*utils.degree, omap=enmap.enmap(om, pw, device="cpu"))
	assert rel(got, want) <= TOL
