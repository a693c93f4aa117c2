"""pixell_tpu_torch.multimap against pixell_tpu.multimap on the CPU, with
inputs made from a numpy seed, float64:

- the ndmaps container (sizes, flat / from_flat, indexing, copy, astype,
  repr) and its arithmetic with scalars and ndmaps on either side, exactly
  (pow within 1e-12);
- the geometry queries (posmap, pixmap, lmap, modlmap, modrmap, pixsizemap,
  pixsize), the statistics (mean, var, std, median, max, min), the per-map
  FFTs and DCTs with their adjoints, map2harm / harm2map and their
  adjoints on IQU, queb_rotmat, rotate_pol and map_mul within 1e-12 of the
  largest reference value;
- nopre, multimap, samegeos, map_union;
- the file IO (write_maps / read_maps, write_map / read_map: the HDF5
  container) both ways against the reference's, exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import multimap as jmultimap, enmap as jenmap
from pixell_tpu_torch import multimap, enmap, utils

TOL = 1e-12


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	return np.abs(got - want).max()/max(np.abs(want).max(), 1e-300)


def geometries(mod):
	g1 = mod.fullsky_geometry(res=10*utils.degree)
	g2 = mod.geometry(pos=np.array([[-2, 2], [2, -2]])*utils.degree, res=0.5*utils.degree)
	return [g1, g2]


def pair(pre=(3,), seed=0):
	"""The same seeded maps as a reference ndmaps and a port ndmaps."""
	rng = np.random.default_rng(seed)
	jm, pm = [], []
	for (s, w), (ps, pw) in zip(geometries(jenmap), geometries(enmap)):
		d = rng.standard_normal(tuple(pre) + tuple(s[-2:]))
		jm.append(jenmap.ndmap(d, w))
		pm.append(enmap.ndmap(torch.from_numpy(d), pw))
	return jmultimap.ndmaps(jm), multimap.ndmaps(pm)


def members(mm):
	return [np.asarray(m) for m in mm.maps]


def check(jmm, pmm, tol=TOL):
	jl = members(jmm) if not isinstance(jmm, list) else [np.asarray(m) for m in jmm]
	pl = [m.data.numpy() for m in pmm.maps]
	assert len(jl) == len(pl)
	for a, b in zip(jl, pl): assert rel(b, a) <= tol


def test_container():
	jmm, pmm = pair()
	assert (pmm.nmap, pmm.npixs, pmm.shape, pmm.ntot, pmm.size, pmm.ndim, pmm.pre) == \
		(jmm.nmap, jmm.npixs, jmm.shape, jmm.ntot, jmm.size, jmm.ndim, jmm.pre)
	assert pmm.dtype == torch.float64 and len(pmm) == 2 and repr(pmm) == repr(jmm)
	assert [g[0] for g in pmm.geometries] == [tuple(g[0]) for g in jmm.geometries]
	flat = pmm.flat()
	assert rel(flat.numpy(), np.asarray(jmm.flat())) == 0
	back = multimap.from_flat(flat, pmm.geometries)
	check(jmm, back, 0)
	check(jmm, pmm.copy(), 0)
	check(jmm, pmm.contig(), 0)
	assert pmm.astype(torch.float32).dtype == torch.float32
	assert rel(pmm[1].data.numpy(), np.asarray(jmm[1])) == 0
	check(jmm[(slice(0, 2),)], pmm[(slice(0, 2),)], 0)   # a selection of components in every map
	assert [m.shape for m in pmm] == [m.shape for m in pmm.maps]
	assert multimap.nopre([((3, 4, 5), None)]) == jmultimap.nopre([((3, 4, 5), None)])
	check(jmultimap.multimap(jmm.maps), multimap.multimap(pmm.maps), 0)
	check(jmultimap.map_union(jmm, jmm), multimap.map_union(pmm, pmm), 0)
	assert isinstance(multimap.samegeos(pmm.maps, pmm), multimap.ndmaps)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "pow"])
def test_arithmetic(op):
	jmm, pmm = pair()
	jo, po = pair(seed=1)
	jo, po = jo*jo + 1, po*po + 1   # positive, for pow
	if op == "pow": jmm, pmm = jmm*jmm + 0.5, pmm*pmm + 0.5
	for jr, pr in [(getattr(jmm, "__%s__" % op)(jo), getattr(pmm, "__%s__" % op)(po)),
			(getattr(jmm, "__%s__" % op)(2.5), getattr(pmm, "__%s__" % op)(2.5)),
			(getattr(jmm, "__r%s__" % op)(2.5), getattr(pmm, "__r%s__" % op)(2.5))]:
		check(jr, pr, TOL if op == "pow" else 0)   # XLA's pow and torch's differ in the last bit
	check(-jmm, -pmm, 0)


def test_geometry_queries():
	jgeo, pgeo = geometries(jenmap), geometries(enmap)
	for name in ["posmap", "pixmap", "lmap", "modlmap", "modrmap", "pixsizemap"]:
		check(getattr(jmultimap, name)(jgeo), getattr(multimap, name)(pgeo, device="cpu"))
	assert rel(multimap.pixsize(pgeo), jmultimap.pixsize(jgeo)) <= TOL
	jmm, pmm = pair()
	for name in ["posmap", "pixmap", "lmap", "modlmap", "modrmap"]:
		check(getattr(jmm, name)(), getattr(pmm, name)())
	assert rel(pmm.pixsize(), jmm.pixsize()) <= TOL


@pytest.mark.parametrize("name", ["mean", "var", "std", "median", "max", "min"])
def test_statistics(name):
	jmm, pmm = pair()
	want = np.asarray(getattr(jmultimap, name)(jmm))
	got = getattr(multimap, name)(pmm)
	assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("name", ["fft", "ifft", "dct", "idct", "fft_adjoint", "ifft_adjoint", "dct_adjoint",
	"idct_adjoint"])
def test_fourier(name):
	jmm, pmm = pair()
	check(getattr(jmultimap, name)(jmm), getattr(multimap, name)(pmm))


@pytest.mark.parametrize("name", ["map2harm", "harm2map", "map2harm_adjoint", "harm2map_adjoint"])
def test_harmonic(name):
	jmm, pmm = pair()
	if name in ("harm2map", "map2harm_adjoint"):
		jmm, pmm = jmultimap.map2harm(jmm), multimap.map2harm(pmm)
	check(getattr(jmultimap, name)(jmm, normalize="phys"), getattr(multimap, name)(pmm, normalize="phys"))


def test_pol_and_products():
	jmm, pmm = pair()
	jl, pl = jmultimap.lmap(geometries(jenmap)), multimap.lmap(geometries(enmap), device="cpu")
	check(jmultimap.queb_rotmat(jl), multimap.queb_rotmat(pl))
	check(jmultimap.rotate_pol(jmm, 0.3), multimap.rotate_pol(pmm, 0.3))
	jmat, pmat = pair(pre=(3, 3), seed=2)
	check(jmultimap.map_mul(jmat, jmm), multimap.map_mul(pmat, pmm))


def test_constructors():
	jgeo, pgeo = geometries(jenmap), geometries(enmap)
	check(jmultimap.zeros(jgeo), multimap.zeros(pgeo, device="cpu"), 0)
	check(jmultimap.full(jgeo, 1.5), multimap.full(pgeo, 1.5, device="cpu"), 0)
	assert multimap.empty(pgeo, device="cpu").npixs == jmultimap.empty(jgeo).npixs


@pytest.mark.parametrize("call", [
	lambda p, j, f: (multimap.write_maps(f, p), jmultimap.read_maps(f)),
	lambda p, j, f: (jmultimap.write_maps(f, j), multimap.read_maps(f, device="cpu")),
	lambda p, j, f: (multimap.write_map(f, p), jmultimap.read_map(f)),
	lambda p, j, f: (jmultimap.write_map(f, j), multimap.read_map(f, device="cpu"))])
def test_io_raises(call, tmp_path):
	"""The file IO, once NotImplementedError (the test keeps its name): the
	port writes and the reference reads, or the other way round, exactly."""
	jmm, pmm = pair()
	_, back = call(pmm, jmm, str(tmp_path/"mm.h5"))
	assert len(back.maps) == len(pmm.maps)
	for b, j in zip(back.maps, jmm.maps):
		got = b.data.numpy() if isinstance(b.data, torch.Tensor) else np.asarray(b)
		assert got.dtype == np.asarray(j).dtype and got.tobytes() == np.asarray(j).tobytes()
		assert b.wcs.to_header() == j.wcs.to_header()
