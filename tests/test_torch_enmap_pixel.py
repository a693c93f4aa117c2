"""pixell_tpu_torch.enmap's pixel side against pixell_tpu.enmap on the CPU
in float64, with inputs made from a numpy seed on a band of the full sky
in RA (20 x 120 pixels of 3 degrees, dec -30 .. 30, 3 components), so
that boxes can cross RA = 180 degrees, and a 24 x 40 CAR patch:

- pixel boxes (skybox2pixbox, pixbox2skybox, subinds in every mode,
  sel2pixbox, pixbox_of, overlap, neighborhood_pixboxes);
- extract / extract_pixbox / insert / insert_at / submap / stamps /
  padslice with RA wrap and pixel boxes partly and wholly outside the
  map, the inserts in place (the target's tensor keeps its storage), the
  insert(submap) roundtrip exact, Padtiler / padtiles;
- the geometry builders (geometry2, fullsky_geometry2, band_geometry2,
  thumbnail_geometry, union_geometry, crop_geometry, subgeo,
  recenter_cyl, create_wcs, the downgrade / upgrade / scale geometries,
  get_downgrade_offset, Geometry.submap / downgrade);
- downgrade, upgrade, pad (wcs held to the exact path: the reference's
  shifts by the map's size less the pad), crop, autocrop,
  find_blank_edges, apod, fillbad, argmax / argmin, map_union,
  tile_maps;
- project (CAR -> CEA, CAR -> TAN, CAR -> CAR; orders 0, 1, 3, 5; the
  zero and cyclic borders) and at (sky positions and unit="pix"); a
  separable project maps only the two axes on the host, a TAN one blocks
  of rows, and the block size changes nothing; float32 within F32_TOL of
  the reference's float64;
- spec2flat's ignored border, and spec2flat_corr against the computation the
  reference's describes (its own raises on indexing);
- the new map-making entry points on CUDA by default;
- the utils the slice calls: the slice-box algebra, block_reduce /
  block_expand, downgrade / upgrade, moveaxis, parse_slice, and eigpow
  on tensors.

Tolerance: 1e-12 of the largest reference value (data copies are exact).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import enmap as jenmap, interpol as jinterpol, powspec as jpowspec
from pixell_tpu_torch import enmap, utils, wcsutils

DEG = utils.degree
TOL = 1e-12
F32_TOL = 2e-5
BAND = np.array([-30, 30])*DEG
POS = np.array([[-5, 8], [3, -6]])*DEG


def rel(got, want):
	got = got.data if isinstance(got, enmap.ndmap) else got
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def same_geo(a, b):
	"""Whether the (shape, wcs) pairs (or maps) a and b agree."""
	sa, wa = (a.shape, a.wcs) if hasattr(a, "wcs") else a
	sb, wb = (b.shape, b.wcs) if hasattr(b, "wcs") else b
	return tuple(sa) == tuple(sb) and list(wa.wcs.ctype) == list(wb.wcs.ctype) and all(
		np.allclose(getattr(wa.wcs, f), getattr(wb.wcs, f), rtol=1e-14, atol=1e-12) for f in ("crpix", "cdelt", "crval"))


def band():
	"""(port map, reference map, data) on the RA-complete band."""
	shape, wcs = enmap.band_geometry(BAND, res=3*DEG)
	_, jwcs = jenmap.band_geometry(BAND, res=3*DEG)
	x = np.random.default_rng(0).standard_normal((3,) + shape)
	return enmap.enmap(x, wcs, device="cpu"), jenmap.enmap(x, jwcs), x


def patch(seed=1, ncomp=3):
	shape, wcs = enmap.geometry(POS, shape=(24, 40), proj="car")
	_, jwcs = jenmap.geometry(POS, shape=(24, 40), proj="car")
	x = np.random.default_rng(seed).standard_normal(((ncomp,) if ncomp else ()) + shape)
	return enmap.enmap(x, wcs, device="cpu"), jenmap.enmap(x, jwcs), x


# boxes [{from, to}, {dec, ra}]: across RA = 180, past the band's edge
# (zero-filled), wholly inside, and across RA = 0
BOXES = [np.array([[-10, 190], [10, 170]])*DEG, np.array([[-40, 30], [5, -10]])*DEG,
	np.array([[-9, 100], [12, 60]])*DEG, np.array([[-3, 20], [25, -40]])*DEG]


# ---------------------------------------------------------------------------
# pixel boxes and the extract family
# ---------------------------------------------------------------------------
def test_pixel_boxes():
	m, jm, _ = band()
	for box in BOXES:
		np.testing.assert_allclose(enmap.skybox2pixbox(m.shape, m.wcs, box, include_direction=True),
			jenmap.skybox2pixbox(jm.shape, jm.wcs, box, include_direction=True), rtol=0, atol=1e-9)
		for mode in [None, "round", "ceil", "inclusive", "exclusive"]:
			for noflip in (False, True):
				np.testing.assert_array_equal(enmap.subinds(m.shape, m.wcs, box, mode=mode, noflip=noflip),
					jenmap.subinds(jm.shape, jm.wcs, box, mode=mode, noflip=noflip))
		pb = enmap.subinds(m.shape, m.wcs, box)
		np.testing.assert_allclose(enmap.pixbox2skybox(m.shape, m.wcs, pb),
			jenmap.pixbox2skybox(jm.shape, jm.wcs, pb), rtol=0, atol=1e-12)
		s, js = m.submap(box), jm.submap(box)
		np.testing.assert_array_equal(enmap.pixbox_of(m.wcs, s.shape, s.wcs), jenmap.pixbox_of(jm.wcs, js.shape, js.wcs))
		np.testing.assert_array_equal(enmap.overlap(m.shape, m.wcs, s.shape, s.wcs),
			jenmap.overlap(jm.shape, jm.wcs, js.shape, js.wcs))
		np.testing.assert_array_equal(m.pixbox_of(s.shape, s.wcs), jm.pixbox_of(js.shape, js.wcs))
	np.testing.assert_array_equal(enmap.sel2pixbox(m.shape, (slice(2, -3), slice(None, None, 1))),
		jenmap.sel2pixbox(jm.shape, (slice(2, -3), slice(None, None, 1))))
	poss = np.array([[0, 3], [0.2, 1]])
	np.testing.assert_array_equal(enmap.neighborhood_pixboxes(m.shape, m.wcs, poss, 0.1),
		jenmap.neighborhood_pixboxes(jm.shape, jm.wcs, poss, 0.1))


@pytest.mark.parametrize("ibox", range(len(BOXES)))
def test_submap_extract_insert(ibox):
	"""submap, extract and the inserts across RA = 180 and past the map's
	edge; the inserts write into the target's tensor."""
	m, jm, x = band()
	box = BOXES[ibox]
	s, js = m.submap(box), jm.submap(box)
	assert rel(s, js) == 0 and same_geo(s, js)
	e, je = enmap.extract(m, s.shape, s.wcs), jenmap.extract(jm, js.shape, js.wcs)
	assert rel(e, je) == 0 and same_geo(e, je)
	# insert into zeros, and with an op
	o = enmap.zeros(m.shape, m.wcs, device="cpu")
	keep = o.data
	ptr = keep.data_ptr()
	assert enmap.insert(o, s) is o and o.data is keep and keep.data_ptr() == ptr
	jo = jenmap.insert(jenmap.zeros(jm.shape, jm.wcs), js)
	assert rel(o, jo) == 0
	o2 = m.copy()
	o2.insert(s, op=lambda a, b: a + 2*b)
	assert rel(o2, jenmap.insert(jm.copy(), js, op=lambda a, b: a + 2*b)) == 0
	# insert(submap) gives back the map where the box lies in it
	r = enmap.zeros(m.shape, m.wcs, device="cpu")
	enmap.insert(r, m.submap(box))
	inside = r.data != 0
	assert bool(inside.any()) and bool((r.data[inside] == m.data[inside]).all())
	# insert_at at a pixel and at a pixbox, crossing the map's x edge
	for pix in ([3, 110], np.array([[3, 110], [3 + s.shape[-2], 110 + s.shape[-1]]])):
		a = enmap.insert_at(enmap.zeros(m.shape, m.wcs, device="cpu"), pix, s)
		assert rel(a, jenmap.insert_at(jenmap.zeros(jm.shape, jm.wcs), pix, js)) == 0


def test_extract_pixbox_outside_and_omap():
	m, jm, _ = band()
	for pb in [np.array([[-5, 110], [8, 140]]), np.array([[25, 10], [30, 20]]), np.array([[-4, -4], [4, 4]])]:
		got, want = m.extract_pixbox(pb, cval=-1), jm.extract_pixbox(pb, cval=-1)
		assert rel(got, want) == 0 and same_geo(got, want)
		# with omap given: written in place through op
		om = enmap.full(got.shape, got.wcs, 2.0, device="cpu")
		res = enmap.extract_pixbox(m, pb, omap=om, op=lambda a, b: a*b)
		jom = jenmap.extract_pixbox(jm, pb, omap=jenmap.full(got.shape, want.wcs, 2.0), op=lambda a, b: a*b)
		assert res.data is om.data and rel(res, jom) == 0
	ps, jps = m.padslice(np.array([[-3, -2], [6, 9]])), jm.padslice(np.array([[-3, -2], [6, 9]]))
	np.testing.assert_array_equal(np.isnan(ps.data.numpy()), np.isnan(np.asarray(jps)))
	assert rel(torch.nan_to_num(ps.data, 7.0), np.nan_to_num(np.asarray(jps), nan=7.0)) == 0 and same_geo(ps, jps)


def test_stamps_and_tiles():
	m, jm, _ = band()
	pos = np.array([[0, 179.5], [5, 3], [-28, -100]])*DEG
	for shape in (5, [4, 7]):
		got, want = m.stamps(pos, shape), jm.stamps(pos, shape)
		assert rel(got, want) == 0 and same_geo(got, want)
	assert len(enmap.stamps(m, pos, 5, aslist=True)) == 3
	# padded tiles read and written back give the map
	tiler = enmap.Padtiler(tshape=[8, 50], pad=2, margin=1)
	tiles = list(tiler.read(m))
	jtiles = list(jenmap.Padtiler(tshape=[8, 50], pad=2, margin=1).read(jm))
	assert len(tiles) == len(jtiles) == 9
	for t, jt in zip(tiles, jtiles): assert rel(t, jt) == 0 and same_geo(t, jt)
	out = tiler.write(enmap.zeros(m.shape, m.wcs, device="cpu"), tiles)
	assert rel(out, m.data.numpy()) == 0
	for a, b in zip(enmap.padtiles(m, m*2, tshape=[8, 50], pad=2, margin=1), tiles):
		assert rel(a[1], 2*b.data.numpy()) == 0


# ---------------------------------------------------------------------------
# geometry operations
# ---------------------------------------------------------------------------
def test_geometry_builders():
	m, jm, _ = band()
	(shape, wcs), (jshape, jwcs) = m.geometry, jm.geometry
	box = BOXES[0]
	s, js = m.submap(box), jm.submap(box)
	pairs = [
		(enmap.downgrade_geometry(shape, wcs, 3), jenmap.downgrade_geometry(jshape, jwcs, 3)),
		(enmap.upgrade_geometry(shape, wcs, [2, 3]), jenmap.upgrade_geometry(jshape, jwcs, [2, 3])),
		(enmap.scale_geometry(shape, wcs, 0.7), jenmap.scale_geometry(jshape, jwcs, 0.7)),
		(enmap.thumbnail_geometry(r=1*DEG, res=0.1*DEG), jenmap.thumbnail_geometry(r=1*DEG, res=0.1*DEG)),
		(enmap.thumbnail_geometry(r=1*DEG, shape=(10, 12), proj="car"),
			jenmap.thumbnail_geometry(r=1*DEG, shape=(10, 12), proj="car")),
		(enmap.geometry2(pos=np.array([[-5, 10], [5, -10]])*DEG, res=0.5*DEG),
			jenmap.geometry2(pos=np.array([[-5, 10], [5, -10]])*DEG, res=0.5*DEG)),
		(enmap.geometry2(pos=np.array([1, 2])*DEG, res=0.5*DEG, shape=(20, 30), proj="cea"),
			jenmap.geometry2(pos=np.array([1, 2])*DEG, res=0.5*DEG, shape=(20, 30), proj="cea")),
		(enmap.geometry2(res=2*DEG), jenmap.geometry2(res=2*DEG)),
		(enmap.fullsky_geometry2(res=2, deg=True), jenmap.fullsky_geometry2(res=2, deg=True)),
		(enmap.band_geometry2([-10, 20], res=2, deg=True), jenmap.band_geometry2([-10, 20], res=2, deg=True)),
		(enmap.union_geometry([s.geometry, m[:, 3:9, 5:20].geometry]),
			jenmap.union_geometry([js.geometry, jm[:, 3:9, 5:20].geometry])),
		(enmap.crop_geometry(shape, wcs, box=box), jenmap.crop_geometry(jshape, jwcs, box=box)),
		(enmap.crop_geometry(shape, wcs, box=np.array([0.1, 0.2]), oshape=(5, 6)),
			jenmap.crop_geometry(jshape, jwcs, box=np.array([0.1, 0.2]), oshape=(5, 6))),
		(enmap.crop_geometry(shape, wcs, pixbox=np.array([[2, 3], [9, 30]]), recenter=True),
			jenmap.crop_geometry(jshape, jwcs, pixbox=np.array([[2, 3], [9, 30]]), recenter=True)),
		(enmap.subgeo(shape, wcs, box=box), jenmap.subgeo(jshape, jwcs, box=box)),
		(enmap.subgeo(shape, wcs, pixbox=np.array([[-2, 3], [9, 130]])),
			jenmap.subgeo(jshape, jwcs, pixbox=np.array([[-2, 3], [9, 130]]))),
		(enmap.recenter_cyl(shape, wcs), jenmap.recenter_cyl(jshape, jwcs)),
		(enmap.recenter_geo(shape, wcs), jenmap.recenter_geo(jshape, jwcs)),
		((shape, enmap.create_wcs(shape)), (jshape, jenmap.create_wcs(jshape))),
		(enmap.Geometry(shape, wcs).submap(box), jenmap.Geometry(jshape, jwcs).submap(box)),
		(enmap.Geometry(shape, wcs).downgrade(2), jenmap.Geometry(jshape, jwcs).downgrade(2)),
	]
	for i, (got, want) in enumerate(pairs):
		assert same_geo(tuple(got), tuple(want)), i
	np.testing.assert_array_equal(enmap.get_downgrade_offset(shape, wcs, 3, ref=[0.1, 0.2]),
		jenmap.get_downgrade_offset(jshape, jwcs, 3, ref=[0.1, 0.2]))
	assert enmap.npix((3, 4, 5)) == jenmap.npix((3, 4, 5)) == 20


# ---------------------------------------------------------------------------
# pixel operations
# ---------------------------------------------------------------------------
def test_resolution_and_padding():
	m, jm, x = patch()
	for f in (2, [2, 3], [5, 7]):
		for got, want in [(enmap.downgrade(m, f), jenmap.downgrade(jm, f)), (m.upgrade(f), jm.upgrade(f)),
				(enmap.upgrade(m, f, oshape=(30, 50)), jenmap.upgrade(jm, f, oshape=(30, 50)))]:
			assert rel(got, want) <= TOL and same_geo(got, want), f
	assert rel(enmap.downgrade(m, 2, op=torch.sum), jenmap.downgrade(jm, 2, op=jnp.sum)) <= TOL
	for pix in (3, [2, 5], [[1, 2], [3, 4]]):
		for wrap in (False, True):
			got, sl = enmap.pad(m, pix, return_slice=True, wrap=wrap, value=1.5)
			want = jenmap.pad(jm, pix, wrap=wrap, value=1.5)
			assert rel(got, want) == 0
			assert rel(got[sl], x) == 0
			# the old pixels keep their sky positions (the reference's wcs moves
			# by the map's size less the pad instead)
			p0 = np.array([sl[1].start, sl[2].start], float)
			np.testing.assert_allclose(got.pix2sky(p0), m.pix2sky(np.zeros(2)), rtol=0, atol=1e-14)
			assert not same_geo(got, want)
	got, want = enmap.crop(m, [2, 3]), jenmap.crop(jm, [2, 3])
	assert rel(got, want) == 0 and same_geo(got, want)


def test_apod_fillbad_crop_edges():
	m, jm, x = patch()
	for profile in ("cos", "lin"):
		for fill in ("zero", "mean", "median"):
			for width in (5, [3, 50]):
				assert rel(m.apod(width, profile=profile, fill=fill), jm.apod(width, profile=profile, fill=fill)) <= TOL
	assert enmap.apod_profile_cos(0.5) == jenmap.apod_profile_cos(0.5) and enmap.apod_profile_lin(0.3) == 0.3
	xb = x.copy()
	xb[0, 3, 4], xb[1, 2, 2], xb[2, 0, 0] = np.nan, np.inf, -np.inf
	b, jb = enmap.enmap(xb, m.wcs, device="cpu"), jenmap.enmap(xb, jm.wcs)
	assert rel(enmap.fillbad(b, 5), jenmap.fillbad(jb, 5)) == 0
	keep = b.data
	assert b.fillbad(-1, inplace=True) is b and b.data is keep and rel(b, jenmap.fillbad(jb, -1)) == 0
	z = np.zeros_like(x)
	z[:, 5:20, 3:31] = x[:, 5:20, 3:31]
	zm, jz = enmap.enmap(z, m.wcs, device="cpu"), jenmap.enmap(z, jm.wcs)
	for margin in (0, 2):
		(got, info), (want, jinfo) = zm.autocrop(margin=margin, return_info=True), \
			jz.autocrop(margin=margin, return_info=True)
		assert rel(got, want) == 0 and same_geo(got, want) and info == jinfo
	for value in (0, "auto", "none", [0, 0, 0]):
		np.testing.assert_array_equal(enmap.find_blank_edges(zm, value), jenmap.find_blank_edges(jz, value))
	for unit in ("coord", "pix"):
		for a, b in [(m, jm), (m[0], jm[0])]:
			for f in ("argmax", "argmin"):
				np.testing.assert_allclose(getattr(enmap, f)(a, unit=unit), getattr(jenmap, f)(b, unit=unit),
					rtol=0, atol=1e-14)


def test_union_and_tiles():
	m, jm, x = patch()
	got, want = enmap.map_union(m[:, :20, :25], m[:, 10:24, 15:40]), \
		jenmap.map_union(jm[:, :20, :25], jm[:, 10:24, 15:40])
	assert rel(got, want) <= TOL and same_geo(got, want)
	tiles = [[m[:, :12, :20], m[:, :12, 20:]], [m[:, 12:, :20], m[:, 12:, 20:]]]
	t = enmap.tile_maps(tiles)
	assert rel(t, x) == 0 and same_geo(t, m)


# ---------------------------------------------------------------------------
# project / at
# ---------------------------------------------------------------------------
TARGETS = {"cea": (np.array([[-15, 185], [15, 140]])*DEG, {}), "car": (np.array([[-12, 200], [20, 150]])*DEG, {}),
	"tan": (np.array([3, 179])*DEG, {"shape": (30, 40)})}


@pytest.mark.parametrize("proj", ["cea", "tan", "car"])
def test_project(proj):
	m, jm, _ = band()
	pos, kw = TARGETS[proj]
	shape, wcs = enmap.geometry(pos, res=0.7*DEG, proj=proj, **kw)
	jshape, jwcs = jenmap.geometry(pos, res=0.7*DEG, proj=proj, **kw)
	for order in (0, 1, 3, 5):
		for border in ("constant", "cyclic"):
			got = m.project(shape, wcs, order=order, border=border)
			want = jenmap.project(jm, jshape, jwcs, order=order, border=border)
			assert rel(got, want) <= TOL and same_geo(got, want), (order, border)
	# float32, and blocks of 7 rows against one block
	want = jenmap.project(jm, jshape, jwcs)
	got = enmap.project(m.astype(torch.float32), shape, wcs)
	assert got.dtype == torch.float32 and rel(got.data.double(), want) <= F32_TOL
	assert rel(enmap.project(m, shape, wcs, bsize=7), enmap.project(m, shape, wcs, bsize=10**6).data.numpy()) == 0
	# the same pixelization and shape: a copy
	c = enmap.project(m, m.shape, m.wcs)
	assert c.data is not m.data and rel(c, m.data.numpy()) == 0


@pytest.mark.parametrize("order", [0, 1, 3])
def test_project_cval(order):
	"""A separable project onto a target that reaches well past the map
	(past the zero border's pad of the spline coefficients too) gives cval
	there as the reference does: the taps outside weigh cval in."""
	m, jm, _ = patch()
	pos = np.array([[-20, 30], [20, -30]])*DEG
	shape, wcs = enmap.geometry(pos, res=DEG, proj="cea")
	jshape, jwcs = jenmap.geometry(pos, res=DEG, proj="cea")
	assert enmap._project_axes(m.shape, m.wcs, shape, wcs, device="cpu") is not None
	for cval in (0.0, 0.5):
		want = jenmap.project(jm, jshape, jwcs, order=order, cval=cval)
		assert np.any(np.asarray(want) == cval)
		assert rel(m.project(shape, wcs, order=order, cval=cval), want) <= TOL, cval


def test_project_host_work(monkeypatch):
	"""A separable project (CAR -> CEA) maps the ny + nx output axes on the
	host, in arrays of at most max(ny, nx) points; a TAN one maps blocks of
	bsize rows."""
	m, _, _ = band()
	sizes = []
	real = wcsutils.world2pix
	def counted(wcs, lon, lat, origin=0):
		sizes.append(np.size(lon))
		return real(wcs, lon, lat, origin)
	monkeypatch.setattr(wcsutils, "world2pix", counted)
	pos, _ = TARGETS["cea"]
	shape, wcs = enmap.geometry(pos, res=0.7*DEG, proj="cea")
	enmap.project(m, shape, wcs, bsize=5)
	assert 0 < max(sizes) <= max(shape) and sum(sizes) <= 2*sum(shape)
	sizes.clear()
	pos, kw = TARGETS["tan"]
	shape, wcs = enmap.geometry(pos, res=0.7*DEG, proj="tan", **kw)
	enmap.project(m, shape, wcs, bsize=5)
	assert max(sizes) == 5*shape[-1] and sum(sizes) == shape[-2]*shape[-1]


def test_at():
	m, jm, _ = band()
	rng = np.random.default_rng(2)
	pos = np.array([rng.uniform(-35, 35, 30), rng.uniform(0, 360, 30)])*DEG
	pix = np.array([rng.uniform(-3, 23, 8), rng.uniform(-5, 125, 8)])
	for order in (0, 1, 3):
		for border in ("constant", "nearest"):
			assert rel(m.at(pos, order=order, border=border), jm.at(pos, order=order, border=border)) <= TOL
		assert rel(enmap.at(m, torch.from_numpy(pix), order=order, unit="pix"),
			jenmap.at(jm, pix, order=order, unit="pix")) <= TOL
	got = enmap.at(m.astype(torch.float32), pos.reshape(2, 5, 6))
	assert got.shape == (3, 5, 6) and got.dtype == torch.float32
	assert rel(got.double(), np.asarray(jenmap.at(jm, pos)).reshape(3, 5, 6)) <= F32_TOL


# ---------------------------------------------------------------------------
# spec2flat's border, spec2flat_corr, defaults
# ---------------------------------------------------------------------------
def spectrum(nl=60):
	l = np.arange(nl)
	ps = np.zeros((2, 2, nl))
	ps[0, 0] = 1/(l + 10)**2
	ps[1, 1] = 0.5/(l + 10)**2
	ps[0, 1] = ps[1, 0] = 0.2/(l + 10)**2
	return ps


def test_spec2flat_border():
	"""spec2flat gives the reference's result in each mode (zero past the
	spectrum's end with mode "constant", else its last entry), and accepts
	and ignores border as the reference does."""
	m, jm, _ = patch(ncomp=0)
	ps = spectrum(30)   # shorter than the plane's |l|
	for mode in ("constant", "nearest"):
		want = jenmap.spec2flat(jm.shape, jm.wcs, ps, mode=mode)
		for border in ("constant", "nearest", "cyclic", "mirror"):
			got = enmap.spec2flat(m.shape, m.wcs, ps, mode=mode, border=border, device="cpu")
			assert rel(got, want) == 0, (mode, border)
			assert rel(got, jenmap.spec2flat(jm.shape, jm.wcs, ps, mode=mode, border=border)) == 0, (mode, border)


def test_spec2flat_corr():
	"""Against the reference's steps with its distance line written as it
	means (the centre pixel's position subtracted): its spec2corr, its
	order-1 map_coordinates and its fft."""
	m, jm, _ = patch(ncomp=0)
	ps = spectrum()
	with pytest.raises(IndexError):
		jenmap.spec2flat_corr(jm.shape, jm.wcs, ps)
	shape, wcs = jm.shape, jm.wcs
	ext = np.asarray(jenmap.extent(shape, wcs))
	rmax = np.sum(ext**2)**0.5
	nr = int(rmax/np.max(ext/np.array(shape)))
	corrfun = jpowspec.spec2corr(ps, np.arange(nr)*rmax/nr)
	dpos = np.asarray(jenmap.posmap(shape, wcs))
	dpos = dpos - dpos[:, shape[0]//2, shape[1]//2][:, None, None]
	ipos = np.arccos(np.clip(np.cos(dpos[0])*np.cos(dpos[1]), -1, 1))*nr/rmax
	corr2d = np.asarray(jinterpol.map_coordinates(jnp.asarray(corrfun), jnp.asarray(ipos.reshape(1, -1)),
		order=1, border="nearest")).reshape(corrfun.shape[:-1] + ipos.shape)
	corr2d = np.roll(np.roll(corr2d, -corr2d.shape[-2]//2, -2), -corr2d.shape[-1]//2, -1)
	want = np.asarray(jenmap.fft(jenmap.ndmap(jnp.asarray(corr2d), wcs)).real)*np.prod(shape)**0.5
	got = enmap.spec2flat_corr(m.shape, m.wcs, ps, device="cpu")
	assert rel(got, want) <= TOL and got.wcs is m.wcs
	got = enmap.spec2flat_corr(m.shape, m.wcs, ps[0, 0], device="cpu")
	assert rel(got[0, 0], want[0, 0]) <= 1e-10


def test_entry_points_default_to_cuda():
	"""With no device argument the new entry points that make a tensor from
	host data allocate on CUDA; without a CUDA device they raise."""
	from pixell_tpu_torch import resample, array_ops
	m, _, x = patch()
	t = np.cumsum(np.ones(20))
	calls = [lambda: enmap.spec2flat_corr(m.shape, m.wcs, spectrum()), lambda: resample.resample(x, 0.5),
		lambda: resample.make_equispaced(np.ones(20), t)[0], lambda: resample.resample_bin(x, [0.5, 0.5]),
		lambda: resample.upsample_bin(x), lambda: array_ops.roll_rows(x[0], np.arange(x.shape[1]))]
	for call in calls:
		if torch.cuda.is_available():
			assert call().device.type == "cuda"
		else:
			with pytest.raises((AssertionError, RuntimeError)):
				call()


# ---------------------------------------------------------------------------
# the utils the slice calls
# ---------------------------------------------------------------------------
def test_utils_sbox_and_blocks():
	"""The slice-box algebra, block_reduce / block_expand, downgrade /
	upgrade (on tensors and numpy), moveaxis, parse_slice and eigpow's
	tensor path against pixell_tpu.utils."""
	from pixell_tpu import utils as jutils
	a = np.array([[2, 9, 1], [-3, 5, 2]])
	b = np.array([[4, 12, 1], [0, 8, 1]])
	for f in ("sbox_size", "sbox_flip", "sbox_fix0", "sbox_fix"):
		np.testing.assert_array_equal(getattr(utils, f)(a), getattr(jutils, f)(a))
	np.testing.assert_array_equal(utils.sbox_fix0(a[:, :2]), jutils.sbox_fix0(a[:, :2]))
	np.testing.assert_array_equal(utils.sbox_fix(np.array([[9, 2, -1]])), jutils.sbox_fix(np.array([[9, 2, -1]])))
	assert utils.sbox2slice(a) == jutils.sbox2slice(a)
	assert utils.sbox2slice(np.array([5, -1, -1])) == jutils.sbox2slice(np.array([5, -1, -1]))
	for f in ("sbox_mul", "sbox_div"):
		np.testing.assert_array_equal(getattr(utils, f)(b, a), getattr(jutils, f)(b, a))
	np.testing.assert_array_equal(utils.sbox_intersect(a, b), jutils.sbox_intersect(a, b))
	assert utils.sbox_intersect(a, np.array([[20, 30, 1], [0, 1, 1]])) is None
	for wrap in (0, 10):
		assert utils.sbox_intersect_1d([2, 9, 1], [8, 15, 1], wrap) == jutils.sbox_intersect_1d([2, 9, 1], [8, 15, 1], wrap)
	for sbox, wrap, cap in [([[-3, 5, 1], [38, 45, 1]], [0, 40], [24, 40]), ([[20, -4, -1], [3, 9, 2]], [0, 0], [24, 40]),
			([[-50, 5, 1], [-90, 10, 1]], [0, 40], [24, 40]), ([[0, 10, 1], [5, 125, 1]], [0, 40], [24, 40])]:
		assert utils.sbox_wrap(np.array(sbox), wrap, cap) == jutils.sbox_wrap(np.array(sbox), wrap, cap)
	x = np.random.default_rng(3).standard_normal((3, 10, 14))
	t = torch.from_numpy(x)
	for inclusive in (True, False):
		for off in (0, 2):
			want = jutils.block_reduce(x, 4, axis=-1, off=off, inclusive=inclusive)
			assert rel(utils.block_reduce(t, 4, axis=-1, off=off, inclusive=inclusive), want) <= TOL
			assert rel(utils.block_reduce(x, 4, axis=-1, off=off, inclusive=inclusive), want) <= TOL
		assert rel(utils.downgrade(t, [3, 4], inclusive=inclusive), jutils.downgrade(x, [3, 4], inclusive=inclusive)) <= TOL
	assert rel(utils.block_reduce(t, 3, axis=1, op=torch.sum), jutils.block_reduce(x, 3, axis=1, op=np.sum)) <= TOL
	for osize, off in ((None, 0), (30, 2)):
		assert rel(utils.block_expand(t, 3, osize=osize, axis=1, off=off), jutils.block_expand(x, 3, osize=osize,
			axis=1, off=off)) == 0
	assert rel(utils.upgrade(t, [2, 3], oshape=(3, 19, 40)), jutils.upgrade(x, [2, 3], oshape=(3, 19, 40))) == 0
	assert rel(utils.moveaxis(t, 0, -1), jutils.moveaxis(x, 0, -1)) == 0
	assert utils.parse_slice("[0,:10,::2]") == jutils.parse_slice("[0,:10,::2]") == (0, slice(None, 10), slice(None, None, 2))
	S = np.einsum("nij,nkj->nik", x[:, :4, :4], x[:, :4, :4])
	for e in (0.5, -1, 2):
		assert rel(utils.eigpow(torch.from_numpy(S), e), jutils.eigpow(S, e)) <= 1e-11
