"""The port's objects on disk against pixell_tpu's, on the CPU, with data
made from a numpy seed:

- fits_io's BINTABLE writer and reader: the port's bytes equal the
  reference's for columns of every kind (float, int, unsigned byte,
  complex, strings, per-row arrays of one and two dimensions), and each
  reads the other's table to the same columns; a bool column, which the
  port writes and both read (the reference's writer raises KeyError on it:
  asserted, ROADMAP Queue 3); a table after an image HDU;
- pointsrcs' FITS catalogues: read with format "fits" (generic ra / dec
  tables in degrees and in radians), "nemo" (RADeg / decDeg / deltaT_c) and
  "dory", read_fits_cat / write_fits_cat, read_dory_fits, read_fits and the
  sauron FITS pair, each against the reference's reader of the same file
  (its read_fits passes the "_header" entry on as a column and raises
  ValueError: asserted, ROADMAP Queue 3);
- tilemap.write_map / read_map on one process, both ways against the
  reference, and on two gloo ranks (tests/torch_dist_worker.py, no JAX): a
  TileMap distributed over the mesh written collectively (rank 0 writes)
  and read back by every rank, the file read by the reference too;
- multimap's IO (write_maps / read_maps, and write_map / read_map, which
  write the same HDF5 container whatever the name) both ways;
- bunch's HDF5 pairs (read / write, read_hdf / write_hdf with a group in the
  path, encode / decode, is_hdf_path / split_hdf_path, concatenate) and
  curvedsky.Bunch2 against the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import torch_dist_worker as W
from pixell_tpu import fits_io as jfits_io, pointsrcs as jpointsrcs, tilemap as jtilemap, enmap as jenmap, \
	multimap as jmultimap, bunch as jbunch, curvedsky as jcurvedsky
from pixell_tpu_torch import fits_io, pointsrcs, tilemap, enmap, multimap, bunch, curvedsky, utils

NROW = 13


def columns():
	rng = np.random.default_rng(3)
	return {"ra": rng.uniform(0, 360, NROW), "flux": rng.standard_normal(NROW).astype(np.float32),
		"n": rng.integers(-2**31, 2**31 - 1, NROW).astype(np.int32), "k": rng.integers(0, 10**12, NROW),
		"s": rng.integers(-300, 300, NROW).astype(np.int16), "b": rng.integers(0, 255, NROW).astype(np.uint8),
		"z": rng.standard_normal(NROW) + 1j*rng.standard_normal(NROW),
		"name": np.array(["src%03d" % i for i in range(NROW)]), "amp": rng.standard_normal((NROW, 3)),
		"flux2d": rng.standard_normal((NROW, 2, 3))}


def same_table(got, want):
	assert [k for k in got if k != "_header"] == [k for k in want if k != "_header"]
	for k in want:
		if k == "_header": continue
		g, w = np.asarray(got[k]), np.asarray(want[k])
		assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def test_bintable(tmp_path):
	cols = columns()
	p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
	fits_io.write_table_fits(p, cols, header={"EXTNAME": "CAT"})
	jfits_io.write_table_fits(r, cols, header={"EXTNAME": "CAT"})
	assert open(p, "rb").read() == open(r, "rb").read()
	got, want = fits_io.read_table(r), jfits_io.read_table(p)
	same_table(got, want)
	for k in ("ra", "n", "name", "flux2d"):
		assert np.array_equal(got[k], cols[k]), k
	assert got["_header"]["EXTNAME"] == "CAT" and fits_io.read_table(p, hdu=1)["_header"]["TFIELDS"] == len(cols)
	# a bool column: the port writes it as L, both read it; the reference's writer raises KeyError (Queue 3)
	flags = {"ok": np.random.default_rng(4).uniform(size=NROW) > 0.5, "ra": cols["ra"]}
	fits_io.write_table_fits(str(tmp_path/"b.fits"), flags)
	for reader in (fits_io.read_table, jfits_io.read_table):
		got = reader(str(tmp_path/"b.fits"))
		assert got["ok"].dtype == bool and np.array_equal(got["ok"], flags["ok"])
	with pytest.raises(KeyError):
		jfits_io.write_table_fits(str(tmp_path/"jb.fits"), flags)
	# the table after an image HDU is found past it
	img = str(tmp_path/"img.fits")
	fits_io.write_map(img, np.zeros((4, 5)))
	with open(img, "ab") as f: f.write(open(p, "rb").read()[2880:])
	same_table(fits_io.read_table(img), jfits_io.read_table(img))


def catalogue(n=20, seed=0):
	rng = np.random.default_rng(seed)
	return bunch.Bunch(ra=rng.uniform(-np.pi, np.pi, n), dec=rng.uniform(-1.2, 1.2, n), I=rng.uniform(1, 5, n),
		Q=rng.standard_normal(n), U=rng.standard_normal(n), snr=rng.uniform(5, 50, n))


def same_cat(got, want):
	for k in (want.keys() if hasattr(want, "keys") else want.dtype.names):
		g, w = np.asarray(got[k]), np.asarray(want[k])
		assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_fits_catalogues(tmp_path):
	cat = catalogue()
	p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
	pointsrcs.write_fits_cat(p, cat)
	jpointsrcs.write_fits_cat(r, cat)
	assert open(p, "rb").read() == open(r, "rb").read()
	for f in (p, r):
		got = pointsrcs.read(f)
		same_cat(got, jpointsrcs.read(f))
		same_cat(pointsrcs.read_fits_cat(f, format="fits"), jpointsrcs.read_fits_cat(f, format="fits"))
	assert np.abs(got.ra - cat.ra).max() < 1e-15 and np.array_equal(got.I, cat.I)
	# ra / dec columns in radians
	rad = str(tmp_path/"rad.fits")
	fits_io.write_table_fits(rad, {"ra": cat.ra, "dec": cat.dec, "flux": cat.I, "flux_Q": cat.Q})
	same_cat(pointsrcs.read(rad), jpointsrcs.read(rad))
	assert np.array_equal(pointsrcs.read(rad).ra, cat.ra)
	# nemo's columns, by format "nemo" and by its RADeg column under "fits"
	nemo = str(tmp_path/"nemo.fits")
	fits_io.write_table_fits(nemo, {"name": np.array(["ACT-CL J%04d" % i for i in range(20)]),
		"RADeg": cat.ra/utils.degree % 360, "decDeg": cat.dec/utils.degree, "deltaT_c": -cat.I,
		"err_deltaT_c": cat.snr/10})
	for fmt in ("nemo", "fits"):
		same_cat(pointsrcs.read(nemo, format=fmt), jpointsrcs.read(nemo, format=fmt))
	# read_fits: the table as a record array, nemo's names fixed; the reference's raises (Queue 3)
	rec = pointsrcs.read_fits(nemo)
	assert rec.dtype.names == ("name", "ra", "dec", "I", "dI") and np.array_equal(rec.I, -cat.I)
	assert pointsrcs.read_fits(nemo, fix=False).dtype.names[1] == "RADeg"
	with pytest.raises(ValueError):
		jpointsrcs.read_fits(nemo)
	# dory: amp [n, {T, Q, U}] in mK
	dory = str(tmp_path/"dory.fits")
	fits_io.write_table_fits(dory, {"ra": cat.ra/utils.degree, "dec": cat.dec/utils.degree,
		"amp": np.array([cat.I, cat.Q, cat.U]).T})
	same_cat(pointsrcs.read_dory_fits(dory), jpointsrcs.read_dory_fits(dory))
	same_cat(pointsrcs.read(dory, format="dory"), jpointsrcs.read(dory, format="dory"))


def sauron(n=7, nfield=2, ncomp=3):
	rng = np.random.default_rng(9)
	dt = [("ra", "d"), ("dec", "d"), ("snr", "d", (ncomp,)), ("flux_tot", "d", (ncomp,)),
		("dflux_tot", "d", (ncomp,)), ("flux", "d", (nfield, ncomp)), ("dflux", "d", (nfield, ncomp)),
		("case", "i"), ("contam", "d", (nfield,))]
	cat = np.zeros(n, dt).view(np.recarray)
	for k in cat.dtype.names: cat[k] = rng.uniform(-1, 1, cat[k].shape)
	cat.case = rng.integers(0, 4, n)
	return cat


def test_sauron_fits(tmp_path):
	cat = sauron()
	p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
	pointsrcs.write_sauron(p, cat)
	jpointsrcs.write_sauron_fits(r, cat)
	assert open(p, "rb").read() == open(r, "rb").read()
	got = pointsrcs.read_sauron(r)
	same_cat(got, jpointsrcs.read_sauron_fits(p))
	assert got.flux.shape == cat.flux.shape and np.abs(got.ra - cat.ra).max() < 1e-15
	assert np.array_equal(got.flux, cat.flux) and np.array_equal(got.case, cat.case)
	same_cat(pointsrcs.read_sauron_fits(p), got)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
	return W.spawn(tmp_path_factory.mktemp("ranks"), ["tilemap_io"], world=2).result()


def maps():
	(js, jw), (ps, pw) = (m.fullsky_geometry(res=3*utils.degree) for m in (jenmap, enmap))
	d = np.random.default_rng(5).standard_normal((2,) + js)
	return jenmap.ndmap(d, jw), enmap.ndmap(torch.from_numpy(d), pw)


def test_tilemap_io(tmp_path, ranks):
	jm, pm = maps()
	active = [0, 3, 5, 11]
	jt, pt = jtilemap.from_enmap(jm, (16, 16), active), tilemap.from_enmap(pm, (16, 16), active)
	p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
	tilemap.write_map(p, pt)
	jtilemap.write_map(r, jt)
	assert open(p, "rb").read() == open(r, "rb").read()
	got, want = tilemap.read_map(r, (16, 16), device="cpu"), jtilemap.read_map(p, (16, 16))
	assert got.data.numpy().tobytes() == np.asarray(want.data).tobytes()
	assert got.geometry.shape == want.geometry.shape and list(got.active) == list(want.active)
	assert got.geometry.wcs.to_header() == want.geometry.wcs.to_header()
	# two ranks: the distributed map written collectively, read by each
	full = np.asarray(jt.to_enmap())
	assert np.array_equal(np.asarray(jtilemap.read_map(str(ranks["tilemap_io/file"]), (16, 16)).to_enmap()), full)
	assert np.array_equal(ranks["tilemap_io/read"], np.asarray(jtilemap.from_enmap(jenmap.ndmap(full, jm.wcs),
		(16, 16)).data))
	assert np.all(ranks["tilemap_io/rank_sums"] == ranks["tilemap_io/read"].sum())


def test_multimap_io(tmp_path):
	(js, jw), (ps, pw) = (m.fullsky_geometry(res=6*utils.degree) for m in (jenmap, enmap))
	rng = np.random.default_rng(2)
	d1, d2 = rng.standard_normal((3,) + js), rng.standard_normal((3, 7, 11))
	jmm = jmultimap.ndmaps([jenmap.ndmap(d1, jw), jenmap.ndmap(d2, jw)])
	pmm = multimap.ndmaps([enmap.ndmap(torch.from_numpy(d1), pw), enmap.ndmap(torch.from_numpy(d2), pw)])
	for write, jread, read, jwrite in ((multimap.write_maps, jmultimap.read_maps, multimap.read_maps,
			jmultimap.write_maps), (multimap.write_map, jmultimap.read_map, multimap.read_map, jmultimap.write_map)):
		p, r = str(tmp_path/"p.fits"), str(tmp_path/"r.fits")
		write(p, pmm)
		jwrite(r, jmm)
		for got, want in ((read(r, device="cpu"), jread(p)), (read(p, device="cpu"), jmm)):
			assert len(got.maps) == len(want.maps) == 2
			for g, w in zip(got.maps, want.maps):
				assert g.data.numpy().tobytes() == np.asarray(w.data).tobytes()
				assert g.wcs.to_header() == w.wcs.to_header()


def test_bunch_hdf(tmp_path):
	b = bunch.Bunch(a=np.arange(5.0), name="x", sub=bunch.Bunch(c=np.int64(3), names=np.array(["u", "vw"])),
		none=None, t=torch.arange(4))
	f = str(tmp_path/"b.hdf")
	bunch.write_hdf(f + "/grp", b)
	got, want = bunch.read_hdf(f + "/grp"), jbunch.read_hdf(f + "/grp")
	assert sorted(got.keys()) == sorted(want.keys()) == ["a", "name", "none", "sub", "t"]
	assert got.name == want.name == "x" and got.none is None and want.none is None
	assert np.array_equal(got.t, np.arange(4)) and np.array_equal(got.sub.names, want.sub.names)
	jbunch.write_hdf(str(tmp_path/"j.hdf"), jbunch.Bunch(a=np.arange(3), s="y"), group="g")
	import h5py
	with h5py.File(str(tmp_path/"j.hdf"), "r") as hf:
		got = bunch.read_hdf(hf, group="g")
	assert np.array_equal(got.a, np.arange(3)) and got.s == "y"
	# read / write: a group per nested Bunch
	bunch.write(str(tmp_path/"w.hdf"), bunch.Bunch(x=np.ones(2), s="z", n=bunch.Bunch(y=np.zeros(3))))
	got, want = bunch.read(str(tmp_path/"w.hdf")), jbunch.read(str(tmp_path/"w.hdf"))
	assert repr(got) == repr(want) and got.s == "z" and np.array_equal(got.n.y, want.n.y)
	assert np.array_equal(bunch.read(str(tmp_path/"w.hdf"), group="n").y, np.zeros(3))
	for path in ("a/b.hdf/c/d", "nodot/x", "a.b/c"):
		assert bunch.is_hdf_path(path) == jbunch.is_hdf_path(path)
		if bunch.is_hdf_path(path):
			for sub in (None, "e"):
				assert bunch.split_hdf_path(path, sub) == jbunch.split_hdf_path(path, sub)
	assert bunch.split_hdf_path(f + "/grp", mode="exists") == (f, "grp") == jbunch.split_hdf_path(f + "/grp",
		mode="exists")
	for v in ("s", None, np.array(["a", "b"]), 3):
		assert np.array_equal(bunch.decode(bunch.encode(v)), jbunch.decode(jbunch.encode(v))) or v is None
	assert bunch.decode(bunch.encode(None)) is None
	parts = [bunch.Bunch(a=np.arange(2), b=1.0), bunch.Bunch(a=np.arange(3), b=2.0)]
	assert repr(bunch.concatenate(parts)) == repr(jbunch.concatenate([jbunch.Bunch(p._dict) for p in parts]))
	assert np.array_equal(bunch.concatenate(parts).a, [0, 1, 0, 1, 2])
	tparts = [bunch.Bunch(a=torch.arange(2)), bunch.Bunch(a=torch.arange(3))]
	assert torch.equal(bunch.concatenate(tparts).a, torch.tensor([0, 1, 0, 1, 2]))
	b2 = bunch.Bunch(a=1); b2.setdefault("c", 5)
	assert list(b2.iteritems()) == [("a", 1), ("c", 5)]


def test_bunch2():
	shape, wcs = enmap.fullsky_geometry(res=2*utils.degree)
	jshape, jwcs = jenmap.fullsky_geometry(res=2*utils.degree)
	p, j = curvedsky.Bunch2(shape, wcs), jcurvedsky.Bunch2(jshape, jwcs)
	assert p.shape == j.shape and curvedsky.get_lmax_from_map(p) == jcurvedsky.get_lmax_from_map(j)
