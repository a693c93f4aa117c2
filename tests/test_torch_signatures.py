"""The public signatures of pixell_tpu_torch.curvedsky, .sht, .enmap,
.fft, .wcsutils, .powspec, .interpol, .resample, .array_ops, .healpix,
.reproject, .coordinates, .sites, .lensing, .aberration, .old_aberration
and .ops.solvers, .multimap, .uharm, .wavelets, .pointsrcs, .distances,
.analysis, .ephem, .coordsys, .fits_io, .bunch, .device, .memory,
.checkpoint, .config, .sqlite, .warray, .enplot, .cgrid, .colorize,
.colors, .scripts, .bench and .utils against pixell_tpu's (and that
healpix, reproject, coordinates, sites, multimap, uharm, pointsrcs,
distances, analysis, ephem, coordsys, fits_io, bunch, device, memory,
checkpoint, config, sqlite, warray, curvedsky, enmap, enplot, cgrid,
colorize, colors, scripts, bench and utils have every public name of the
reference's modules but the ones listed as not ported (of utils,
cached_jit and fence), and
fft, lensing, aberration, old_aberration, ops.solvers and wavelets every
public function and class): every public name both modules define takes the reference's
parameters, by name and in order, and the port's own extras (device=,
leg_dtype=) come after them and are keyword-only, so a call written for
the reference means the same in the port. Deliberate differences of the
config-5 modules: mesh= (UHT, WaveletTransform) and offload= are kept in
the signatures, mesh= takes a torch.distributed DeviceMesh (the reference's
jax Mesh; anything else raises TypeError) and
offload=None means no offload (the reference's OFFLOAD_BYTES threshold is
not ported); the file IO (enmap, multimap, tilemap, pointsrcs' FITS
catalogues, checkpoint) keeps the reference's signatures and reads onto
device=; device= is the port's keyword-only extra where a result is made
on a device. Then the calls themselves: map2alm
and rand_alm with every argument by position, as the reference allows, and
the out= and copy= arguments, held against the reference at lmax 16 in
float64 (1e-10 of the largest value; rand_alm draws the same numpy numbers,
so exactly).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import curvedsky as jcurvedsky, sht as jsht, enmap as jenmap, fft as jfft, \
	wcsutils as jwcsutils, powspec as jpowspec, interpol as jinterpol, resample as jresample, \
	array_ops as jarray_ops, healpix as jhealpix, reproject as jreproject, coordinates as jcoordinates, \
	sites as jsites, lensing as jlensing, aberration as jaberration, old_aberration as jold_aberration, \
	multimap as jmultimap, uharm as juharm, wavelets as jwavelets, pointsrcs as jpointsrcs, utils as jutils, \
	distances as jdistances, analysis as janalysis, ephem as jephem, coordsys as jcoordsys, fits_io as jfits_io, \
	bunch as jbunch, device as jdevice, memory as jmemory, checkpoint as jcheckpoint, config as jconfig, \
	sqlite as jsqlite, warray as jwarray, enplot as jenplot, cgrid as jcgrid, colorize as jcolorize, colors as jcolors, \
	scripts as jscripts, bench as jbench
from pixell_tpu.ops import solvers as jsolvers
from pixell_tpu_torch import curvedsky, sht, enmap, fft, wcsutils, powspec, interpol, resample, array_ops, \
	healpix, reproject, coordinates, sites, lensing, aberration, old_aberration, multimap, uharm, wavelets, \
	pointsrcs, utils, distances, analysis, ephem, coordsys, fits_io, bunch, device, memory, checkpoint, config, sqlite, \
	warray, enplot, cgrid, colorize, colors, scripts, bench
from pixell_tpu_torch.ops import solvers

LMAX = 16
SHAPE = (20, 40)
PAIRS = {"curvedsky": (jcurvedsky, curvedsky), "sht": (jsht, sht), "enmap": (jenmap, enmap),
	"fft": (jfft, fft), "wcsutils": (jwcsutils, wcsutils), "powspec": (jpowspec, powspec),
	"interpol": (jinterpol, interpol), "resample": (jresample, resample), "array_ops": (jarray_ops, array_ops),
	"healpix": (jhealpix, healpix), "reproject": (jreproject, reproject), "coordinates": (jcoordinates, coordinates),
	"sites": (jsites, sites), "lensing": (jlensing, lensing), "aberration": (jaberration, aberration),
	"old_aberration": (jold_aberration, old_aberration), "solvers": (jsolvers, solvers),
	"multimap": (jmultimap, multimap), "uharm": (juharm, uharm), "wavelets": (jwavelets, wavelets),
	"pointsrcs": (jpointsrcs, pointsrcs), "distances": (jdistances, distances), "analysis": (janalysis, analysis),
	"ephem": (jephem, ephem), "coordsys": (jcoordsys, coordsys), "fits_io": (jfits_io, fits_io),
	"bunch": (jbunch, bunch), "device": (jdevice, device), "memory": (jmemory, memory),
	"checkpoint": (jcheckpoint, checkpoint), "config": (jconfig, config), "sqlite": (jsqlite, sqlite),
	"warray": (jwarray, warray), "enplot": (jenplot, enplot), "cgrid": (jcgrid, cgrid),
	"colorize": (jcolorize, colorize), "colors": (jcolors, colors), "scripts": (jscripts, scripts),
	"bench": (jbench, bench), "utils": (jutils, utils)}
# public names of the reference's modules that the port leaves out on purpose (ROADMAP "Not ported")
NOT_PORTED = {"device": {"donating_jit", "enable_compilation_cache"}, "curvedsky": {"SYNTH_BAND_BYTES"},
	"enmap": set(), "utils": {"cached_jit", "fence"}}
UTILS_PORTED_TO = 2921   # utils' names are held up to this line of pixell_tpu/utils.py (its end)


def shared_names():
	"""(module, name) for every public callable both modules define, and
	(module, "class.method") for the public methods of shared classes."""
	out = []
	for mod, (ref, port) in PAIRS.items():
		for name in sorted(dir(port)):
			if name.startswith("_") or not hasattr(ref, name): continue
			r, p = getattr(ref, name), getattr(port, name)
			if inspect.ismodule(p) or not callable(p) or not callable(r): continue
			# an exception class has no signature of its own to compare
			if inspect.isclass(p) and issubclass(p, BaseException): continue
			out.append((mod, name))
			if inspect.isclass(p) and inspect.isclass(r):
				out += [(mod, "%s.%s" % (name, m)) for m, _ in inspect.getmembers(p, inspect.isfunction)
					if not m.startswith("_") and callable(getattr(r, m, None))]
	return out


def lookup(module, name):
	obj = module
	for part in name.split("."): obj = getattr(obj, part)
	return obj


@pytest.mark.parametrize("mod,name", shared_names(), ids=lambda x: x)
def test_reference_parameters_come_first(mod, name):
	ref, port = PAIRS[mod]
	rp = list(inspect.signature(lookup(ref, name)).parameters.values())
	pp = list(inspect.signature(lookup(port, name)).parameters.values())
	assert [p.name for p in pp[:len(rp)]] == [p.name for p in rp]
	assert [p.kind for p in pp[:len(rp)]] == [p.kind for p in rp]
	# the port's own parameters take no position a reference call could fill
	extra = pp[len(rp):]
	assert all(p.kind in (p.KEYWORD_ONLY, p.VAR_KEYWORD) for p in extra), [p.name for p in extra]


def test_the_check_covers_the_entry_points():
	names = {n for _, n in shared_names()}
	assert {"alm2map", "map2alm", "rand_alm", "rand_alm_white", "rand_map", "lmul", "almxfl",
		"alm_info.lmul", "alm_info.alm2cl", "prepare_alm", "synthesis", "analysis",
		"fft", "ifft", "map2harm", "harm2map", "lbin", "geometry", "ndmap.fft", "ndmap.sum", "dct", "build",
		"pixelization", "read_spectrum", "spec2flat", "rand_map", "map_coordinates", "spline_filter",
		"project", "at", "submap", "extract", "extract_pixbox", "insert", "insert_at", "stamps", "downgrade",
		"upgrade", "ndmap.project", "ndmap.at", "ndmap.submap", "ndmap.insert", "Geometry.submap", "resample",
		"resample_bin", "make_equispaced", "matmul", "eigpow", "roll_rows", "find_contours", "apod", "pad",
		"crop", "union_geometry", "geometry2", "thumbnail_geometry", "spec2flat_corr", "Padtiler.read",
		"ip_linear", "build", "alm2map_healpix", "map2alm_healpix", "get_ring_info_healpix", "prepare_healmap",
		"fill_gauss", "rand_alm_healpy", "to_healpix", "from_healpix", "ndmap.to_healpix", "map2healpix",
		"healpix2map", "thumbnails", "transform", "get_interpol", "positions", "expand_site",
		"lens_map_curved", "lens_map", "offset_by_grad", "boost_map", "Aberrator", "Aberrator.aberrate",
		"Modulator.modulate", "remap", "apply_aberration", "cg_solve", "jacobi_refine", "iu2nu", "inu2u",
		"nufft", "inufft", "nufft_adjoint", "inufft_adjoint", "shift_interp", "ndmaps", "ndmaps.flat", "from_flat",
		"UHT", "UHT.map2harm", "UHT.harm2map", "UHT.hmul", "UHT.sum_hprof", "WaveletTransform",
		"WaveletTransform.map2wave", "WaveletTransform.wave2map", "ButterTrim", "HaarTransform.map2wave",
		"sim_objects", "radial_sum", "sim_srcs", "crossmatch", "cellify", "read_sauron", "read_map", "write_map",
		"read_fits", "read_hdf", "ndmap_proxy_fits", "ndmap_proxy_fits.read", "ndmap.write", "read_helper",
		"open_proxy", "read_table", "write_table_fits", "FitsProxy", "read_fits_cat", "save_pytree", "load_pytree",
		"Workspace.ensure", "get_device", "read_hdf_recursive"} <= names


def public(m):
	return {n for n in dir(m) if not n.startswith("_") and not inspect.ismodule(getattr(m, n))
		and getattr(getattr(m, n), "__module__", m.__name__) == m.__name__}


@pytest.mark.parametrize("mod", ["healpix", "reproject", "coordinates", "sites", "multimap", "uharm", "pointsrcs",
	"distances", "analysis", "ephem", "coordsys", "fits_io", "bunch", "device", "memory", "checkpoint", "config",
	"sqlite", "warray", "curvedsky", "enmap", "enplot", "cgrid", "colorize", "colors", "scripts", "bench", "utils"])
def test_every_public_name(mod):
	"""healpix, reproject, coordinates, sites, multimap, uharm, pointsrcs,
	distances, analysis, ephem, coordsys, fits_io, bunch, device, memory,
	checkpoint, config, sqlite, warray, curvedsky, enmap, enplot, cgrid,
	colorize, colors, scripts, bench and utils have every public name of the
	reference's modules but those in NOT_PORTED, and those names are
	absent."""
	ref, port = PAIRS[mod]
	skip = NOT_PORTED.get(mod, set())
	assert public(ref) - set(dir(port)) == skip
	assert skip <= public(ref)


def utils_names_in_range():
	"""The public names pixell_tpu/utils.py defines at its top level up to
	line UTILS_PORTED_TO (functions, classes and assigned constants), from
	its source."""
	import ast
	tree = ast.parse(inspect.getsource(jutils))
	names = set()
	for node in tree.body:
		if node.lineno > UTILS_PORTED_TO: break
		if isinstance(node, (ast.FunctionDef, ast.ClassDef)): names.add(node.name)
		elif isinstance(node, ast.Assign):
			names |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
	return {n for n in names if not n.startswith("_")}


def test_utils_names_up_to_data_missing():
	"""utils has every public name of pixell_tpu/utils.py, from its
	constants through redistribute (:2921), but cached_jit and fence, which
	worked around the TPU runtime, and those two are absent; the constants
	have the reference's values."""
	names = utils_names_in_range()
	assert len(names) == 371
	assert {n for n in names if not hasattr(utils, n)} == NOT_PORTED["utils"]
	for n in names - NOT_PORTED["utils"]:
		r, p = getattr(jutils, n), getattr(utils, n)
		if isinstance(r, (float, int, np.ndarray)):
			assert type(p) is type(r) and np.array_equal(p, r), n


@pytest.mark.parametrize("mod", ["fft", "lensing", "aberration", "old_aberration", "solvers", "wavelets"])
def test_every_public_callable(mod):
	"""fft, lensing, aberration, old_aberration, ops.solvers and wavelets
	have every public function and class of the reference's modules. (Of
	the reference's constants, fft.GATHER_CHUNK, lensing.ROWBAND_MAX_NXS and
	wavelets.OFFLOAD_BYTES size TPU workarounds that are not ported.)"""
	ref, port = PAIRS[mod]
	public = {n for n in dir(ref) if not n.startswith("_") and (inspect.isfunction(getattr(ref, n))
		or inspect.isclass(getattr(ref, n))) and getattr(ref, n).__module__ == ref.__name__}
	assert public - set(dir(port)) == set()
	assert all(callable(getattr(port, n)) for n in public)


@pytest.mark.parametrize("name", ["czeros", "RadialFourierTransform", "crossmatch"])
def test_utils_additions(name):
	"""The utils names the config-5 modules brought: the reference's
	parameters first, the port's extras keyword-only."""
	rp = list(inspect.signature(getattr(jutils, name)).parameters.values())
	pp = list(inspect.signature(getattr(utils, name)).parameters.values())
	assert [(p.name, p.kind) for p in pp[:len(rp)]] == [(p.name, p.kind) for p in rp]
	assert all(p.kind == p.KEYWORD_ONLY for p in pp[len(rp):])


def geometry():
	jshape, jwcs = jenmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	shape, wcs = enmap.fullsky_geometry(shape=SHAPE, variant="fejer1")
	return jwcs, wcs


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def test_positional_calls_match_reference():
	"""rand_alm(ps, ainfo, lmax, seed, dtype, m_major, return_ainfo) and
	map2alm(map, alm, lmax, spin, deriv, adjoint, copy, method, ainfo,
	verbose, nthread, niter) by position, as the reference takes them."""
	jwcs, wcs = geometry()
	ps = np.zeros((3, 3, LMAX + 1)); ps[0, 0] = 1; ps[1, 1, 2:] = ps[2, 2, 2:] = 0.5
	ja, jinfo = jcurvedsky.rand_alm(ps, None, LMAX, 3, np.complex128, True, True)
	a, info = curvedsky.rand_alm(ps, None, LMAX, 3, torch.complex128, True, True, device="cpu")
	np.testing.assert_array_equal(a.numpy(), ja)
	assert (info.lmax, info.mmax, info.nelem) == (jinfo.lmax, jinfo.mmax, jinfo.nelem)
	jm = jcurvedsky.alm2map(ja, jenmap.zeros((3,) + SHAPE, jwcs), [0, 2], False, False, False,
		"auto", None, False, None, None, 1e-6)
	m = curvedsky.alm2map(a, enmap.zeros((3,) + SHAPE, wcs, device="cpu"), [0, 2], False, False,
		False, "auto", None, False, None, None, 1e-6)
	assert rel(m.data, jm) <= 1e-10
	tm = enmap.ndmap(torch.from_numpy(np.array(jm)), wcs)
	for niter in (0, 1):
		jr = jcurvedsky.map2alm(jm, None, LMAX, [0, 2], False, False, False, "auto", None, False,
			None, niter)
		r = curvedsky.map2alm(tm, None, LMAX, [0, 2], False, False, False, "auto", None, False,
			None, niter)
		assert rel(r, jr) <= 1e-10, niter
		assert rel(r, ja) <= 1e-10, niter


def test_out_and_copy():
	"""out= writes into the given tensor and returns it; map2alm writes into
	a given alm, and with copy=True into a copy, leaving alm as it was."""
	jwcs, wcs = geometry()
	ja = jcurvedsky.rand_alm(np.ones(LMAX + 1), lmax=LMAX, seed=4)
	a = torch.from_numpy(ja.copy())
	fl = 1/(1 + np.arange(LMAX + 1.0))
	ainfo = curvedsky.alm_info(lmax=LMAX)
	want = np.asarray(jcurvedsky.almxfl(ja, fl))
	for call in (lambda out: curvedsky.almxfl(a, fl, None, out),
			lambda out: curvedsky.lmul(a, fl, None, out),
			lambda out: ainfo.lmul(a, fl, out)):
		out = torch.zeros_like(a)
		assert call(out) is out
		assert rel(out, want) <= 1e-14
	with pytest.raises(ValueError):
		curvedsky.lmul(a, fl, out=torch.zeros(3, dtype=a.dtype))
	jm = jcurvedsky.alm2map(ja, jenmap.zeros(SHAPE, jwcs), spin=[0])
	tm = enmap.ndmap(torch.from_numpy(np.array(jm)), wcs)
	given = torch.zeros_like(a)
	r = curvedsky.map2alm(tm, given, spin=[0], copy=True)
	assert r is not given and bool((given == 0).all()) and rel(r, ja) <= 1e-10
	r = curvedsky.map2alm(tm, given, spin=[0])
	assert r is given and rel(given, ja) <= 1e-10
	# rand_alm_white: the reference's positions, and its ainfo back
	w, winfo = curvedsky.rand_alm_white(ainfo, (2,), 5, True, True, torch.complex128, device="cpu")
	jw, _ = jcurvedsky.rand_alm_white(ainfo, (2,), 5, True, True, np.complex128)
	assert winfo is ainfo
	np.testing.assert_array_equal(w.numpy(), jw)
