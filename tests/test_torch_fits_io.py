"""pixell_tpu_torch's maps on disk (fits_io and enmap's IO) against
pixell_tpu's, on the CPU, with maps made from a numpy seed:

- a map the reference writes is read by the port, and one the port writes
  by the reference, bit for bit with the same wcs: float32, float64, int16,
  int32 and uint8, 2d and [3, ny, nx], as .fits, .fits.gz, .npy and .hdf;
  the port's .fits and .npy bytes equal the reference's (its FITS writer
  puts no date in the file), also on a CEA band with extra header cards;
- read_map's selections (sel, a sky box across RA = 180, a pixel box
  reaching outside the map, a geometry, 'f.fits:[...]', and their mix)
  against the reference's read_map on the same file, exactly; the delayed
  proxy sliced (negative steps too) against the map in memory; the box
  reads of a proxy against submap of the whole map; an HDF5 proxy;
- the native box reader (built into build/ from the port's own source)
  against the Python reader, its plain twin, for every BITPIX and for boxes
  touching each edge of the image, into a strided piece of a larger buffer
  too; the image HDU after an
  empty primary, as the reference's reader finds it; a failed build raises,
  and the native reader has no quiet fallback;
- the _header / _geometry / _dtype readers, write_fits_geometry,
  get_stokes_flips, fix_endian and parse_slice against the reference (its
  write_fits_geometry raises TypeError and its read_hdf_geometry drops the
  wcs: asserted, ROADMAP Queue 3).
"""
import ctypes
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, fits_io as jfits_io, utils as jutils
from pixell_tpu_torch import enmap, fits_io, utils
from pixell_tpu_torch.ops import _build

SHAPE = (20, 40)   # a 9-degree full-sky Fejer-1 map
DTYPES = [np.float32, np.float64, np.int16, np.int32, np.uint8]


def geometries():
	return jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1"), enmap.fullsky_geometry(shape=SHAPE, variant="fejer1")


def data(dtype, pre=(), seed=0):
	rng = np.random.default_rng(seed)
	shape = tuple(pre) + SHAPE
	if np.dtype(dtype).kind == "f": return rng.standard_normal(shape).astype(dtype)
	info = np.iinfo(dtype)
	return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def host(x):
	if isinstance(x, enmap.ndmap): x = x.data
	if isinstance(x, torch.Tensor): return x.detach().numpy()
	return np.asarray(x)


def same_map(got, want):
	"""The port's map equal to the reference's bit for bit, of the same
	dtype, and with the same wcs."""
	g, w = host(got), np.asarray(want)
	assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
	assert g.tobytes() == w.tobytes()
	assert got.wcs.to_header() == want.wcs.to_header()


def pair(dtype, pre=()):
	(_, jwcs), (_, wcs) = geometries()
	d = data(dtype, pre)
	return jenmap.ndmap(d, jwcs), enmap.enmap(d, wcs, device="cpu")


@pytest.mark.parametrize("ext", [".fits", ".fits.gz", ".npy", ".hdf"])
@pytest.mark.parametrize("pre", [(), (3,)], ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_roundtrip_both_ways(tmp_path, dtype, pre, ext):
	jm, pm = pair(dtype, pre)
	mine, theirs = str(tmp_path/("port" + ext)), str(tmp_path/("ref" + ext))
	enmap.write_map(mine, pm)
	jenmap.write_map(theirs, jm)
	got = enmap.read_map(theirs, device="cpu")
	back = jenmap.read_map(mine)
	if ext == ".npy":   # a .npy file holds no wcs: both read a plain one
		same_map(got, jenmap.read_map(theirs))
		same_map(enmap.read_map(mine, device="cpu"), back)
		assert np.asarray(back).tobytes() == host(pm).tobytes()
	else:
		same_map(got, jm)
		same_map(pm, back)
	if ext in (".fits", ".npy"):
		assert open(mine, "rb").read() == open(theirs, "rb").read()
	pm.write(str(tmp_path/("method" + ext)))
	same_map(enmap.read_map(str(tmp_path/("method" + ext)), wcs=pm.wcs, device="cpu"), pm)


def test_fits_bytes_cea_and_extra_cards(tmp_path):
	"""A CEA band with extra cards of every kind: the same bytes."""
	box = np.array([[-20, 30], [25, -40]])*utils.degree
	jshape, jwcs = jenmap.geometry(pos=box, res=2*utils.degree, proj="cea")
	shape, wcs = enmap.geometry(pos=box, res=2*utils.degree, proj="cea")
	d = data(np.float64, (2,))[..., :shape[0], :shape[1]]
	extra = {"TELESCOP": "ACT", "FREQ": 150, "GAIN": 1.25, "POLCCONV": "IAU", "FLAG": True}
	enmap.write_map(str(tmp_path/"p.fits"), enmap.enmap(d, wcs, device="cpu"), extra=extra)
	jenmap.write_map(str(tmp_path/"r.fits"), jenmap.ndmap(d, jwcs), extra=extra)
	assert open(tmp_path/"p.fits", "rb").read() == open(tmp_path/"r.fits", "rb").read()
	hdr = enmap.read_fits_header(str(tmp_path/"p.fits"))
	assert hdr == jenmap.read_fits_header(str(tmp_path/"p.fits")) and hdr["FREQ"] == 150 and hdr["FLAG"] is True


BOX = np.array([[-25, 200], [30, 160]])*utils.degree   # across RA = 180, ra decreasing


def selections(jwcs, wcs):
	"""(name, the reference's read_map arguments, the port's)."""
	gshape, gw = enmap.slice_geometry(SHAPE, wcs, (slice(3, 15), slice(-6, 30)), nowrap=True)
	jgshape, jgw = jenmap.slice_geometry(SHAPE, jwcs, (slice(3, 15), slice(-6, 30)), nowrap=True)
	pixbox = np.array([[-3, -5], [10, 50]])
	return [
		("sel", dict(sel=(slice(None), slice(2, 12), slice(5, None, 3))), None),
		("box", dict(box=BOX), None),
		("pixbox", dict(pixbox=pixbox), None),
		("geometry", dict(geometry=(jgshape, jgw)), dict(geometry=(gshape, gw))),
		("fname_slice", "[1,3:9]", None),
		("sel_and_box", dict(sel=(slice(0, 2),), box=BOX), None),
		("nowrap_pixbox", dict(pixbox=pixbox, wrap=0), None)]


@pytest.mark.parametrize("case", range(7), ids=["sel", "box", "pixbox", "geometry", "fname_slice", "sel_and_box",
	"nowrap_pixbox"])
def test_read_selections(tmp_path, case):
	jm, pm = pair(np.float64, (3,))
	f = str(tmp_path/"m.fits")
	enmap.write_map(f, pm)
	(_, jwcs), (_, wcs) = geometries()
	name, jargs, pargs = selections(jwcs, wcs)[case]
	if isinstance(jargs, str):
		want, got = jenmap.read_map(f + ":" + jargs), enmap.read_map(f + ":" + jargs, device="cpu")
	else:
		want, got = jenmap.read_map(f, **jargs), enmap.read_map(f, **(pargs or jargs), device="cpu")
	same_map(got, want)
	# a box read of the proxy reads the pieces: the same as submap of the whole map
	if name == "box":
		proxy = enmap.read_map(f, delayed=True, device="cpu")
		assert isinstance(proxy, enmap.ndmap_proxy_fits)
		same_map(enmap.submap(proxy, BOX), pm.submap(BOX))
		same_map(enmap.read_map(f, box=BOX, delayed=True, device="cpu"), pm.submap(BOX))
		hp = str(tmp_path/"m.hdf")
		enmap.write_map(hp, pm)
		same_map(enmap.read_map(hp, box=BOX, device="cpu"), want)


@pytest.mark.parametrize("ext", [".fits", ".hdf"])
def test_proxies(tmp_path, ext):
	_, pm = pair(np.float32, (2, 3))
	f = str(tmp_path/("m" + ext))
	enmap.write_map(f, pm)
	proxy = enmap.ndmap_proxy_fits(f, device="cpu") if ext == ".fits" else enmap.ndmap_proxy_hdf(f, device="cpu")
	assert proxy.shape == pm.shape and proxy.ndim == 4 and proxy.dtype == torch.float32
	assert proxy.geometry[1].to_header() == pm.wcs.to_header()
	for sel in [(1, slice(None), slice(2, 9), slice(None, None, -3)), (Ellipsis, slice(15, 3, -2), slice(5, 6)),
			(0, 2, 4), (Ellipsis, 7), (slice(None), slice(None), slice(None), slice(30, 50))]:
		got, want = proxy[sel], pm[sel]
		if isinstance(want, enmap.ndmap): same_map(got, want)
		else: assert torch.equal(got, want), sel
	same_map(proxy.read(), pm)
	flat = proxy.preflat
	assert flat.shape == (6,) + SHAPE and flat.ndim == 3
	same_map(flat[4, 2:5], pm.preflat()[4, 2:5])
	same_map(enmap.extract_pixbox(flat, np.array([[-2, 35], [5, 48]])),
		enmap.extract_pixbox(pm.preflat(), np.array([[-2, 35], [5, 48]])))


def test_fits_io_module_against_reference(tmp_path):
	"""fits_io's own reader, writer and proxy on the reference's files, and
	the other way round."""
	d = data(np.int16, (2,))
	hdr = {"CTYPE1": "RA---CAR", "CDELT1": -9.0, "OBJECT": "it's"}
	fits_io.write_map(str(tmp_path/"p.fits"), d, hdr)
	jfits_io.write_map(str(tmp_path/"r.fits"), d, hdr)
	assert open(tmp_path/"p.fits", "rb").read() == open(tmp_path/"r.fits", "rb").read()
	# a quote in a string value is doubled in the file; the reference's reader keeps it doubled (Queue 3)
	for reader, obj in ((fits_io.read_map, "it's"), (jfits_io.read_map, "it''s")):
		got, h = reader(str(tmp_path/"p.fits"))
		assert got.tobytes() == d.tobytes() and got.dtype == d.dtype and h["OBJECT"] == obj
	(shape, h), (jshape, jh) = fits_io.read_header(str(tmp_path/"r.fits")), jfits_io.read_header(str(tmp_path/"r.fits"))
	assert shape == jshape and {k: v for k, v in h.items() if k != "OBJECT"} == \
		{k: v for k, v in jh.items() if k != "OBJECT"}
	p, jp = fits_io.open_proxy(str(tmp_path/"r.fits")), jfits_io.open_proxy(str(tmp_path/"r.fits"))
	assert p.native and p.shape == jp.shape and p.dtype == jp.dtype and p.ndim == 3
	assert np.array_equal(p[1, 4:9, 30:], jp[1, 4:9, 30:]) and np.array_equal(p[:, 2, ::-1], d[:, 2, ::-1])
	fits_io.write_map(str(tmp_path/"p.fits.gz"), d)
	g = fits_io.open_proxy(str(tmp_path/"p.fits.gz"))
	assert not g.native and np.array_equal(g[0, 1:3], d[0, 1:3])
	# the float32 scaled data of BSCALE / BZERO, as the reference's reader gives them
	fits_io.write_map(str(tmp_path/"s.fits"), d, {"BSCALE": 0.5, "BZERO": 3.0})
	want, _ = jfits_io.read_map(str(tmp_path/"s.fits"))
	got = enmap.read_map(str(tmp_path/"s.fits"), device="cpu")
	assert np.array_equal(host(got), want) and host(got).dtype == want.dtype
	assert np.array_equal(host(enmap.read_map(str(tmp_path/"s.fits"), sel=(1, slice(2, 5)), device="cpu")),
		want[1, 2:5])


BITPIX = [8, 16, 32, 64, -32, -64]


def edge_boxes(ny, nx):
	return [(0, ny, 0, nx), (0, 3, 0, 5), (ny - 3, ny, nx - 5, nx), (2, 7, nx - 1, nx), (0, 1, 0, nx),
		(ny - 1, ny, 3, 4), (5, 6, 0, 1), (4, 4, 2, 9)]


@pytest.mark.parametrize("bitpix", BITPIX)
def test_native_reader_against_python(tmp_path, bitpix):
	dtype = np.dtype(fits_io._bitpix2dtype[bitpix]).newbyteorder("=")
	rng = np.random.default_rng(abs(bitpix))
	shape = (2, 3) + SHAPE
	if dtype.kind == "f": d = rng.standard_normal(shape).astype(dtype)
	else: d = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
	f = str(tmp_path/"b.fits")
	fits_io.write_map(f, d)
	twin, _ = fits_io.read_map(f)
	proxy = fits_io.open_proxy(f)
	assert proxy.native and proxy.bitpix == bitpix and proxy.dtype == dtype
	for (y1, y2, x1, x2) in edge_boxes(*SHAPE):
		want = twin[..., y1:y2, x1:x2]
		got = proxy.read_box(y1, y2, x1, x2)
		assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (y1, y2, x1, x2)
		# into a piece of a larger buffer (the pieces of a wrapped box)
		big = np.full((2, 3, 30, 60), 7, dtype)
		proxy.read_box(y1, y2, x1, x2, out=big[..., 4:4 + y2 - y1, 9:9 + x2 - x1])
		assert np.array_equal(big[..., 4:4 + y2 - y1, 9:9 + x2 - x1], want)
		rest = big.copy(); rest[..., 4:4 + y2 - y1, 9:9 + x2 - x1] = 7
		assert (rest == 7).all()
	with pytest.raises(IndexError):
		proxy.read_box(0, SHAPE[0] + 1, 0, 3)


def extension_file(fname, d):
	"""An empty primary HDU, then d as an IMAGE extension."""
	card = fits_io._format_card
	prim = [card("SIMPLE", True), card("BITPIX", 8), card("NAXIS", 0), card("EXTEND", True), card("END", None)]
	ext = [card("XTENSION", "IMAGE"), card("BITPIX", -64), card("NAXIS", d.ndim)]
	ext += [card("NAXIS%d" % (i + 1), n) for i, n in enumerate(d.shape[::-1])]
	ext += [card("PCOUNT", 0), card("GCOUNT", 1), card("CTYPE1", "RA---CAR"), card("CTYPE2", "DEC--CAR"),
		card("CDELT1", -9.0), card("CDELT2", 9.0), card("CRPIX1", 20.5), card("CRPIX2", 10.5),
		card("CRVAL1", 0.0), card("CRVAL2", 0.0), card("END", None)]
	raw = d.astype(">f8").tobytes()
	with open(fname, "wb") as f:
		f.write(fits_io._header_text(prim) + fits_io._header_text(ext) + raw + b"\0"*((-len(raw)) % 2880))


def test_extension_hdu(tmp_path):
	"""The image after an empty primary: read_map finds it, as the
	reference's reader does, through the native reader at HDU 1."""
	d = data(np.float64, (3,))
	f = str(tmp_path/"ext.fits")
	extension_file(f, d)
	got, want = enmap.read_map(f, device="cpu"), jenmap.read_map(f)
	same_map(got, want)
	proxy = enmap.read_map(f, delayed=True, device="cpu")
	assert proxy.proxy.hdu == 1 and proxy.proxy.native
	same_map(proxy[:, 3:8, ::2], want[:, 3:8, ::2])
	assert fits_io.read_header(f, hdu=1)[0] == d.shape and fits_io.read_header(f)[0] == ()


def test_native_build(tmp_path, monkeypatch):
	"""The native reader is built from the port's own source into build/,
	never loaded from the reference's cpp/; a failed build raises, and so
	does a proxy when the reader cannot be had (no quiet fallback)."""
	core = fits_io._get_core()
	path = core._name
	assert os.path.dirname(os.path.dirname(path)) == str(_build.BUILD_ROOT)
	assert os.path.basename(os.path.dirname(path)).startswith("host-") and not path.endswith("cpp/libfitsio_core.so")
	assert (_build.HOST_SRC/"fitsio_core.cpp").exists() and _build.HOST_SRC.parent.name == "pixell_tpu_torch"
	(tmp_path/"bad.cpp").write_text("this is not C++\n")
	with pytest.raises(RuntimeError, match="building"):
		_build.load_host("bad", src=tmp_path)
	def broken(name, src=None): raise RuntimeError("no compiler")
	monkeypatch.setattr(fits_io, "_core", None)
	monkeypatch.setattr(_build, "load_host", broken)
	f = str(tmp_path/"m.fits")
	fits_io.write_map(f, data(np.float32))
	with pytest.raises(RuntimeError, match="no compiler"):
		enmap.read_map(f, device="cpu")
	assert isinstance(core, ctypes.CDLL)


def test_geometry_readers(tmp_path):
	jm, pm = pair(np.float32, (3,))
	f, h = str(tmp_path/"m.fits"), str(tmp_path/"m.hdf")
	enmap.write_map(f, pm); enmap.write_map(h, pm)
	assert enmap.read_fits_header(f) == jenmap.read_fits_header(f)
	for port, ref in [(enmap.read_fits_geometry(f), jenmap.read_fits_geometry(f)),
			(enmap.read_map_geometry(f), jenmap.read_map_geometry(f)),
			(enmap.read_map_geometry(h), jenmap.read_map_geometry(h))]:
		assert port[0] == ref[0] == pm.shape and port[1].to_header() == ref[1].to_header() == pm.wcs.to_header()
	assert enmap.read_fits_dtype(f) == jenmap.read_fits_dtype(f) == np.float32
	assert enmap.read_map_dtype(f) == jenmap.read_map_dtype(f) and enmap.read_map_dtype(h) == jenmap.read_map_dtype(h)
	assert enmap.read_hdf_dtype(h) == jenmap.read_hdf_dtype(h) == np.float32
	# read_hdf_geometry: the port reads write_hdf's wcs; the reference gives a plain one (Queue 3)
	shape, wcs = enmap.read_hdf_geometry(h)
	jshape, jwcs = jenmap.read_hdf_geometry(h)
	assert shape == jshape and wcs.to_header() == pm.wcs.to_header() and jwcs.to_header() != pm.wcs.to_header()
	# write_fits_geometry: a header with no data, read by both; the reference's raises TypeError (Queue 3)
	g = str(tmp_path/"g.fits")
	enmap.write_map_geometry(g, (3, 2000, 4000), pm.wcs)
	assert os.path.getsize(g) == 2880
	for reader in (enmap.read_fits_geometry, jenmap.read_fits_geometry, jenmap.read_map_geometry):
		s, w = reader(g)
		assert s == (3, 2000, 4000) and w.to_header() == pm.wcs.to_header()
	with pytest.raises(TypeError):
		jenmap.write_fits_geometry(str(tmp_path/"j.fits"), (3, 20, 40), jm.wcs)
	with pytest.raises(NotImplementedError):
		enmap.write_map_geometry(g, (20, 40), pm.wcs, fmt="hdf")


def test_small_helpers(tmp_path):
	hdr = {"POLCCONV": "IAU"}
	assert enmap.get_stokes_flips(hdr) == jenmap.get_stokes_flips(hdr) == -1
	big = data(np.float64, (2,)).astype(">f8")
	fixed = enmap.fix_endian(big)
	assert fixed.dtype.isnative and np.array_equal(fixed, np.asarray(jenmap.fix_endian(big)))
	_, pm = pair(np.float32)
	assert enmap.fix_endian(pm) is pm
	for s in ["[0,:10,::2]", "[1:3]", "[,5]", "[]", "[-1:2:3, 4]"]:
		assert enmap.parse_slice(s) == jenmap.parse_slice(s)
	for s in ["[0,:10,::2]", "[1:3]", "[...,5]", "[::-1,None]"]:   # read_map's file-name slices
		assert utils.parse_slice(s) == jutils.parse_slice(s)
	# reads land on the card unless told otherwise: without one they raise
	if not torch.cuda.is_available():
		enmap.write_map(str(tmp_path/"m.fits"), pm)
		for ext in ("fits", "npy"):
			enmap.write_map(str(tmp_path/("m." + ext)), pm)
			with pytest.raises(RuntimeError): enmap.read_map(str(tmp_path/("m." + ext)))
	for bad, err in (("0,1", ValueError), ("[None]", NotImplementedError)):
		with pytest.raises(err): enmap.parse_slice(bad)
		with pytest.raises(err): jenmap.parse_slice(bad)
