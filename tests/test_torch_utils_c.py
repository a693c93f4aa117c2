"""pixell_tpu_torch.utils' names of pixell_tpu/utils.py:1951-2921 (shapes,
parsing, waves and physics, bases and linear operators, tables, dtypes,
strings and sexagesimal, files, environment and iterators, Airy beams and
disks, formatting, broadcasting, polygons and the communicator helpers)
against the reference on the same numpy inputs, made from seeds: integers,
booleans, strings, shapes and structures exactly, float64 within 1e-12
relative to the largest value. The helpers that take tensors also run on
CPU tensors and must answer with tensors there. The files, environment
and glob helpers run in tmp_path and monkeypatch. The reference faults
the port does not copy, and the quirks it keeps, are asserted of both
(ROADMAP Queue 3). reduce and redistribute also run on two gloo ranks
(tests/torch_dist_worker.py), against numpy's sum and the one-rank result."""
import copy
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import torch_dist_worker as W
from test_torch_utils_b import host, match, tensorize, tensors_on
from pixell_tpu import utils as jutils
from pixell_tpu_torch import utils
from pixell_tpu_torch.parallel.dist import FakeCommunicator, TorchCommunicator

rng = np.random.default_rng(1951)
X = rng.standard_normal((3, 6, 10))
C = np.einsum("nik,njk->nij", X[:, :4], X[:, :4]) + np.eye(4)   # [3, 4, 4] covariances
BAD = X.copy()
BAD[0, 1, 2], BAD[1, 3, 4], BAD[2, 0, 0] = np.nan, np.inf, -np.inf
POLY = np.array([[0.1, 0.1], [0.9, 0.2], [0.7, 0.8], [0.4, 0.5], [0.2, 0.9]])
PTS = rng.uniform(-0.1, 1.1, (40, 2))
SKY = np.array([[0.1, -0.2], [0.6, -0.1], [0.5, 0.4], [0.05, 0.3]])   # [nv, {ra, dec}]


def call(fn, args, kw):
	"""fn(*args, **kw) on copies (some helpers work in place), a generator's values as a list."""
	with np.errstate(all="ignore"):
		res = fn(*copy.deepcopy(args), **copy.deepcopy(kw))
	return list(res) if inspect.isgenerator(res) else res


HOST = [
	("rewind_compact", (np.array([3.0, -3.0, 3.1, 2.9]),), {}, False),
	("rewind_compact", (np.array([[350.0, 10, 5], [90, 100, 270]]),), {"period": 360, "axis": 0}, False),
	("find_rewind_compact_ref", (rng.uniform(-4, 4, (2, 7)),), {"axis": 1}, False),
	("find_rewind_compact_ref", (np.zeros((3, 0)),), {}, True),
	("hasoff", (np.array([1.5, 2.0, 3.5000001]), 0.5), {}, True),
	("fix_zero_strides", (np.broadcast_to(X[0, :1], (1, 10)),), {}, True),
	("greedy_split", ([3, 1, 4, 1, 5, 9, 2, 6], 3), {}, True),
	("greedy_split_simple", ([3, 1, 4, 1, 5, 9, 2, 6], 3), {}, True),
	("unpackbits", ([3, 200],), {}, True),
	("combine_beams", ([[1, 2, 0.1], [2, 1, -0.2], [0.5, 0.7, 0.0]],), {}, False),
	("parse_ints", ("1,2:5,8",), {}, True),
	("parse_floats", ("1.5,2:4:0.5,-3",), {}, True),
	("parse_numbers", ("1,2:5,8:10:0.5",), {}, True),
	("parse_numbers", ("7",), {"dtype": np.int32}, True),
	("parse_box", ("0:1,2:3,-4:5.5",), {}, True),
	("type2_wave", (np.linspace(0, 1, 25),), {}, False),
	("type2_wave", (np.linspace(0, 3, 25),), {"period": 1.5, "amp": 1.2, "mid": 0.1}, False),
	("iplanck_T", (np.array([30e9, 150e9]), np.array([1e-19, 3e-18])), {}, False),
	("noise_flux_factor", (1e-7, np.array([90e9, 150e9])), {}, False),
	("noise_flux_factor", (2e-7, 220e9, 3.0), {}, False),
	("tsz_profile_los_exact", (np.array([0.3, 1.0]),), {}, False),
	("is_int_valued", (np.array([1.0, 2.0]),), {}, True),
	("is_int_valued", (np.array([1.0, 2.5]),), {}, True),
	("build_legendre", (np.linspace(3, 5, 11), 5), {}, False),
	("build_legendre", (np.array(0.3), 3), {}, False),
	("build_cossin", (np.linspace(0, 3, 11), 5), {}, False),
	("uvec", (5, 2), {}, True),
	("uvec", (3, 0, np.int32), {}, True),
	("build_conditional", (np.einsum("ij,n->ijn", C[0], np.array([1.0, 2.0, 0.5])), [0, 2]), {}, False),
	("build_conditional", (C.transpose(1, 2, 0), [1]), {}, False),
	("split_slice_simple", ((1, slice(2), None, 4), [1, 2, 1]), {}, True),
	("unflatten_slice", (slice(2, 9, 3), (3, 4)), {}, True),
	("outer_stack", ([np.arange(3), np.arange(4.0)],), {}, True),
	("tform_to_profile", (np.exp(-np.arange(60)/10.0), np.array([0.0, 0.01, 0.1, 0.5])), {}, False),
	("tform_to_profile", (np.exp(-np.arange(60)/10.0), np.array([0.0, 0.01])), {"normalize": True}, False),
	("beam_transform_to_profile", (np.exp(-np.arange(30)/5.0), np.array([0.02, 0.2])), {}, False),
	("fix_dtype_mpi4py", (">f8",), {}, True),
	("native_dtype", (">i4",), {}, True),
	("native_dtype", ("<c16",), {}, True),
	("decode_array_if_necessary", (np.array([b"ab", b"c"]),), {}, True),
	("decode_array_if_necessary", (np.array([1, 2]),), {}, True),
	("encode_array_if_necessary", (np.array(["ab", "c"]),), {}, True),
	("chararray_slice", (["abc", "de", "fghi"], slice(0, 2)), {}, True),
	("to_sexa", (-12.5,), {}, True),
	("to_sexa", (123.4567,), {}, False),
	("to_sexa", (0.0,), {}, True),
	("from_sexa", (-1, 12, 30, 15.0), {}, False),
	("format_sexa", (-12.5,), {}, True),
	("format_sexa", (3.25, "%(deg)d %(min)d %(sec).1f"), {}, True),
	("jname", (1.0, -0.2), {}, True),
	("jname", (np.array([1.0, 4.0]), np.array([-0.3, 0.4])), {"tag": "ACT"}, True),
	("jname", (np.array([200.0, 10.0]), np.array([-5.5, 45.0])), {"tag": "X", "sep": "-"}, True),
	("ascomplex", (np.arange(3, dtype=np.float32),), {}, True),
	("ascomplex", ([1.0, 2.0],), {}, True),
	("astuple", ([1, 2],), {}, True),
	("astuple", (4,), {}, True),
	("default_M", (X[0],), {}, True),
	("default_dot", (X[0], X[1]), {}, False),
	("default_dot", (X[0] + 1j*X[1], X[2] - 0.5j*X[0]), {}, False),
	("without_inds", ([1, 2, 3, 4], [1, 3]), {}, True),
	("without_inds", ((5, 6), None), {}, True),
	("only_inds", ([1, 2, 3, 4], [3, 0]), {}, True),
	("can_import", ("numpy",), {}, True),
	("can_import", ("no_such_module_x",), {}, True),
	("replace", ("abcabc", "bc", "X"), {}, True),
	("regreplace", ("a1b22c", r"\d+", "#"), {}, True),
	("regreplace", ("a1b22c", r"\d+", "#", 1), {}, True),
	("primes", (360,), {}, True),
	("primes", (97,), {}, True),
	("res2nside", (0.01,), {}, True),
	("nside2res", (512,), {}, False),
	("split_esc", (r"a,b\,c,,d", ","), {}, True),
	("iscontig", (X,), {}, True),
	("iscontig", (X[:, :, ::2],), {}, True),
	("iscontig", (X[:, ::2],), {"naxes": 1}, True),
	("zip2", ([1, 2, 3], "ab", (7, 8, 9)), {}, True),
	("arg_help", (5,), {}, True),
	("dicedist", (3, 4), {}, False),
	("distpow", (np.array([0.2, 0.5, 0.3]), 5), {}, False),
	("airy", (np.array([0, 0.5, 1.0, 2.3]),), {}, False),
	("lairy", (np.linspace(-0.2, 1.2, 15),), {}, False),
	("airy_lmax", (6.0, 2e-3), {}, False),
	("airy_res", (6.0, 2e-3), {}, False),
	("airy_area", (6.0, 2e-3), {}, False),
	("disk_overlap", (np.linspace(0, 3, 7), 1.0), {}, False),
	("disk_overlap_curved", (np.array([0.01, 0.02, 0.035]), 0.02), {}, False),
	("disk_overlap_curved", (np.array([1e-5, 2e-5]), 1e-5), {}, False),
	("freq2ind", (np.array([0.5, 2.0]), 10.0), {}, False),
	("ind2freq", (np.array([5, 20]), 10.0), {}, False),
	("firstin", ({"b": 1, "c": 2}, ["a", "c", "b"]), {}, True),
	("firstin", ("xyz", ["a"]), {}, True),
	("ndigit", ([0, 9, 10, 12345, 99999],), {}, True),
	("afmt", (np.array([1.5, 2]),), {"ffmt": "%.2f"}, True),
	("afmt", (np.arange(20),), {"ifmt": "%03d", "nmax": 5, "nedge": 2}, True),
	("afmt", (np.array([1.5, 2]), "%5.1f"), {}, True),
	("contains_any", ("abcdef", ["x", "cd"]), {}, True),
	("contains_any", ([1, 2], [3]), {}, True),
	("format_to_glob", ("map_%03d_%s_%%.fits",), {}, True),
	("format_to_regex", ("map_%03d_%s_%.2f%%_%x.fits",), {}, True),
	("find", ([5, 3, 1, 7], [1, 5, 7]), {}, True),
	("find", ([1, 3, 5, 7], [7, 3]), {"sorted": True}, True),
	("find", ([5, 3, 1], [2, 3]), {"default": -1}, True),
	("find", ([5, 3, 1], []), {}, True),
	("broadcast_shape", ((3, 4), (4,)), {}, True),
	("broadcast_shape", ((3, 1, 5), (3, 1), ()), {"at": -1}, True),
	("broadcast_shape", ((3, 4), (3,)), {"at": -1}, True),
]


@pytest.mark.parametrize("case", range(len(HOST)), ids=lambda i: "%s-%d" % (HOST[i][0], i))
def test_host(case):
	name, args, kw, exact = HOST[case]
	match(call(getattr(utils, name), args, kw), call(getattr(jutils, name), args, kw), exact)


TENSOR = [
	("deslope", (X,), {}, False),
	("deslope", (X[0],), {"axis": 0, "w": 2}, False),
	("deslope", (X,), {"w": 3}, False),
	("cov2corr", (C,), {}, False),
	("corr2cov", (C/4, np.array([1.0, 2.0, 3.0, 0.5])), {}, True),
	("nodiag", (C,), {}, True),
	("atleast_3d", (X[0, 0],), {}, True),
	("atleast_3d", (X,), {}, True),
	("atleast_Nd", (X[0], 5), {}, True),
	("to_Nd", (X, 2), {}, True),
	("to_Nd", (X, 2), {"axis": -1, "return_inverse": True}, True),
	("to_Nd", (X[0, 0], 3), {}, True),
	("to_Nd", (X[0, 0], 3), {"axis": 1}, True),
	("preflat", (X, 2), {}, True),
	("preflat", (X, -1), {}, True),
	("postflat", (X, 2), {}, True),
	("postflat", (X, 0), {}, True),
	("blockify", (X, 3), {}, True),
	("block_mean_filter", (X, 3), {}, False),
	("block_mean_filter", (X[0, 0], 4), {}, False),
	("block_mean_filter", (np.arange(7), 20), {}, False),
	("tofinite", (BAD,), {}, True),
	("tofinite", (BAD, -1.5), {}, True),
	("remove_nan", (BAD,), {}, True),
	("without_nan", (BAD,), {}, True),
	("triangle_wave", (np.linspace(-3, 3, 61),), {}, True),
	("triangle_wave", (np.linspace(-3, 3, 61),), {"period": 0.7}, True),
	("gnfw", (np.linspace(0.01, 5, 30), 0.5, 1.0, 4.65, -0.3), {}, False),
	("matvec", (C, X[:, :4, 0]), {}, False),
	("slice_downgrade", (X, slice(1, None, 3)), {}, False),
	("slice_downgrade", (X, slice(None, 5)), {"axis": 1}, True),
	("slice_downgrade", (np.arange(12).reshape(3, 4), slice(0, 3, 2), 0), {}, False),
	("ang2chord", (np.linspace(0, np.pi, 13),), {}, False),
	("chord2ang", (np.linspace(0, 2, 13),), {}, False),
	("point_in_polygon", (PTS, POLY), {}, True),
	("point_in_polygon", (np.array([[0.5, 0.5], [2, 2], [0.5, 0.15]]), np.array([POLY, POLY[::-1]*0.5])[:, None]),
		{}, True),
	("point_in_polygon", (np.array([[0, 0], [1, 1]]), np.array([[-1, -1], [2, -1], [2, 2], [-1, 2]])), {}, True),
	("poly_edge_dist", (PTS*0.6 - 0.1, SKY), {}, False),
	("poly_edge_dist", (np.array([[0.3, 0.1], [0.6, -0.1], [2.0, 1.0]]), SKY), {}, False),
]


@pytest.mark.parametrize("case", range(len(TENSOR)), ids=lambda i: "%s-%d" % (TENSOR[i][0], i))
def test_tensor_helpers(case):
	"""Each helper on numpy against the reference, then on CPU tensors:
	tensors on the CPU, the reference's values."""
	name, args, kw, exact = TENSOR[case]
	want = call(getattr(jutils, name), args, kw)
	match(call(getattr(utils, name), args, kw), want, exact)
	got = call(getattr(utils, name), tensorize(args), tensorize(kw))
	assert tensors_on(got, "cpu"), type(got)
	match(host(got), want, exact)


def test_in_place_on_tensors():
	"""remove_nan and deslope(inplace=True) write into the tensor given."""
	t = torch.from_numpy(BAD.copy())
	assert utils.remove_nan(t) is t and bool(torch.isfinite(t).all())
	d = torch.from_numpy(X.copy())
	assert utils.deslope(d, inplace=True) is d
	match(d.numpy(), jutils.deslope(X), False)


def test_eigsort():
	"""eigsort against the reference: the eigenvalues, and the eigenvectors
	up to sign (through V E V^T and |V|); merged as V sqrt(E) times its
	transpose."""
	for kw in ({}, {"nmax": 2}):
		jE, jV = jutils.eigsort(C, **kw)
		for A in (C, torch.from_numpy(C)):
			E, V = host(utils.eigsort(A, **kw))
			match(E, jE, False)
			match(np.abs(V), np.abs(jV), False)
			match(np.einsum("nij,nj,nkj->nik", V, E, V), np.einsum("nij,nj,nkj->nik", jV, jE, jV), False)
	jm = jutils.eigsort(C, merged=True)
	for A in (C, torch.from_numpy(C)):
		m = host(utils.eigsort(A, merged=True))
		match(np.einsum("nij,nkj->nik", m, m), np.einsum("nij,nkj->nik", jm, jm), False)
		match(np.einsum("nij,nkj->nik", m, m), C, False)


def test_identity_helpers():
	"""same_array, getaddr, call_help, cache_get and ubash."""
	a = np.arange(10.0)
	for u in (utils, jutils):
		assert u.same_array(a, a) and not u.same_array(a, a.copy()) and not u.same_array(a, a[::2])
		assert u.getaddr(a[3:]) == a.__array_interface__["data"][0] + 24
	f = lambda *args, **kw: (args, kw)
	assert utils.call_help(f, 1, None, x=None) == jutils.call_help(f, 1, None, x=None) == ((1, None), {"x": None})
	cache, n = {}, []
	op = lambda: n.append(1) or len(n)
	assert utils.cache_get(cache, "k", op) == 1 and utils.cache_get(cache, "k", op) == 1 and len(n) == 1
	assert utils.cache_get(None, "k", op) == 2
	A = rng.standard_normal((4, 3))
	match(utils.ubash(lambda x: A @ x, 3), jutils.ubash(lambda x: A @ x, 3), True)
	match(utils.ubash(lambda x: A @ x, 3, odtype=np.float32), jutils.ubash(lambda x: A @ x, 3, odtype=np.float32),
		True)


def test_iterators():
	for bases in ([2, 3], [1, 4, 2], []):
		assert list(utils.count_variable_basis(bases)) == list(jutils.count_variable_basis(bases))
	il = [[1, 2], ["a"], [3.0, 4.0, 5.0]]
	assert list(utils.list_combination_iter(il)) == list(jutils.list_combination_iter(il))


def test_raises():
	"""The helpers that raise do so as the reference."""
	for u in (utils, jutils):
		with pytest.raises(ValueError): u.replace("abc", "x", "y")
		with pytest.raises(ValueError): u.regreplace("abc", r"\d", "y")
		with pytest.raises(ValueError): u.find([5, 3, 1], [2])
		with pytest.raises(ValueError): u.broadcast_shape((3, 4), (5,))
		with pytest.raises(KeyError): u.getrec(np.zeros(2, [("a", float)]), ["b"])


def test_tables_and_files(tmp_path, monkeypatch, capsys):
	"""read_lines, load_ascii_table, getrec, glob, globlist, rm, getenv,
	setenv and aprint, in tmp_path and monkeypatch."""
	fn = tmp_path/"tab.txt"
	fn.write_text("# ra dec name\n1.5 2 abc\n\n2.5 3 de\n-1 7 xyz\n")
	for sel in ("", ":1:", ":2", ":-1"):
		assert utils.read_lines(str(fn) + sel) == jutils.read_lines(str(fn) + sel)
	for desc, kw in (("ra:f8 dec:i4 name:U8", {}), ("ra:f8 | name:U4", {}), ("ra:f4,dec:f8", {"dsep": ","})):
		got, want = utils.load_ascii_table(str(fn), desc, **kw), jutils.load_ascii_table(str(fn), desc, **kw)
		assert got.dtype == want.dtype and type(got) is type(want)
		for name in want.dtype.names: match(got[name], want[name], True)
		assert np.array_equal(utils.getrec(got, ["x", want.dtype.names[-1]]), jutils.getrec(want, ["x",
			want.dtype.names[-1]]))
	for name in ("a_1.fits", "a_2.fits", "b.txt"): (tmp_path/name).write_text("")
	for pat in ("a_*.fits", "*", "nothing_*", "no_such_file"):
		assert utils.glob(str(tmp_path/pat)) == jutils.glob(str(tmp_path/pat))
	assert sorted(utils.glob(str(tmp_path/"a_*"), sort=False)) == utils.glob(str(tmp_path/"a_*"))
	pats = [str(tmp_path/"a_*"), str(tmp_path/"b.txt")]
	assert utils.globlist(pats) == jutils.globlist(pats)
	utils.rm(str(tmp_path/"b.txt")); utils.rm(str(tmp_path/"b.txt"))
	assert not (tmp_path/"b.txt").exists()
	monkeypatch.setenv("PT_UTILS_X", "1")
	monkeypatch.delenv("PT_UTILS_Y", raising=False)
	assert utils.getenv("PT_UTILS_X") == "1" and utils.getenv("PT_UTILS_Y", "d") == "d"
	utils.setenv("PT_UTILS_X", 5, keep=True)
	assert utils.getenv("PT_UTILS_X") == "1"
	utils.setenv("PT_UTILS_X", 5)
	assert jutils.getenv("PT_UTILS_X") == "5"
	utils.setenv("PT_UTILS_X", None)
	assert "PT_UTILS_X" not in os.environ
	monkeypatch.delenv("PT_UTILS_X", raising=False)
	utils.aprint(np.array([1.5, 2]), ffmt="%.1f")
	jutils.aprint(np.array([1.5, 2]), ffmt="%.1f")
	out = capsys.readouterr().out.split("\n")
	assert out[0] == out[1] == "[1.5 2.0]"


def test_tsz_tform():
	"""tsz_tform on the port's profile_to_tform_hankel and tsz_profile_los."""
	for kw in ({"lmax": 3000}, {"r200": 2*utils.arcmin, "l": np.array([10.0, 500.5, 8000.0]), "beta": 4.0}):
		match(utils.tsz_tform(**kw), jutils.tsz_tform(**kw), False)


# ---------------------------------------------------------------------------
# Reference faults not copied, and quirks kept (ROADMAP Queue 3)
# ---------------------------------------------------------------------------
def test_deslope_every_axis():
	"""pixell_tpu/utils.py:1981: the reference's reshape copies the rows of
	an inner axis, so deslope(d, axis=1) of a 3d d leaves d as it was; the
	port takes out every row's slope, the reference's answer with that
	axis moved last."""
	d = X.copy()
	np.testing.assert_array_equal(jutils.deslope(d, axis=1), d)
	want = np.moveaxis(jutils.deslope(np.moveaxis(d, 1, -1).copy(), w=2), -1, 1)
	match(utils.deslope(d, axis=1, w=2), want, False)
	match(utils.deslope(torch.from_numpy(d), axis=1, w=2).numpy(), want, False)
	# a row average that is not the mean goes row by row on a tensor too
	want = np.moveaxis(jutils.deslope(np.moveaxis(d, 1, -1).copy(), w=3, avg=np.median), -1, 1)
	match(utils.deslope(torch.from_numpy(d), axis=1, w=3, avg=lambda r: r.median()).numpy(), want, False)


def test_rewind_compact_rows():
	"""pixell_tpu/utils.py:1958: rewind_compact along the last axis of a 2d
	array leaves the reference angles [nrow] without that axis: they raise
	against [nrow, ncol], and on a square array go to the columns. The
	port rewinds each row about its own angle, the reference's answer row
	by row."""
	a = np.array([[350.0, 10, 5], [90, 100, 270]])
	with pytest.raises(ValueError):
		jutils.rewind_compact(a, period=360)
	sq = np.array([[350.0, 10, 5], [90, 100, 270], [170, 190, 185]])
	want = np.array([jutils.rewind_compact(row, period=360) for row in sq])
	assert not np.allclose(jutils.rewind_compact(sq, period=360), want)
	for x in (a, sq):
		match(utils.rewind_compact(x, period=360), np.array([jutils.rewind_compact(row, period=360) for row in x]),
			False)
	match(utils.rewind_compact(sq.T, period=360, axis=0), want.T, False)


def test_scalar_results():
	"""pixell_tpu/utils.py:2680 and :2246: disk_overlap_curved and
	tsz_profile_los_exact give shape (1,) for a scalar, though each has a
	branch for the scalar that atleast_1d leaves dead; the port gives the
	scalar, the reference's one value."""
	want = jutils.disk_overlap_curved(0.01, 0.02)
	assert want.shape == (1,)
	got = utils.disk_overlap_curved(0.01, 0.02)
	assert isinstance(got, float) and abs(got - want[0]) <= 1e-12*abs(want[0])
	want = jutils.tsz_profile_los_exact(0.5)
	assert want.shape == (1,)
	got = utils.tsz_profile_los_exact(0.5)
	assert np.ndim(got) == 0 and abs(got - want[0]) <= 1e-12*abs(want[0])


def test_poly_edge_dist_near_a_vertex():
	"""pixell_tpu/utils.py:2852: the distance to a vertex as arccos(p . v)
	loses half the digits near the vertex (1.8e-4 relative 1e-6 rad away,
	0 for 1e-9); the port's atan2(|p x v|, p . v) keeps them: points due
	south of the first vertex, whose nearest edge point is that vertex,
	at the distance moved within 1e-7 relative, on numpy and on tensors."""
	for d in (1e-3, 1e-6, 1e-9):
		p = SKY[:1] - [0, d]
		for got in (utils.poly_edge_dist(p, SKY), utils.poly_edge_dist(torch.from_numpy(p), SKY).numpy()):
			assert abs(got[0]/d - 1) < 1e-7, (d, got)
		if d < 1e-4: assert abs(jutils.poly_edge_dist(p, SKY)[0]/d - 1) > 1e-5


class StubComm:
	"""A communicator of two ranks with mpi4py's lower-case calls but no
	Reduce, as pixell_tpu.parallel.dist.JaxCommunicator."""
	size, rank = 2, 0
	def bcast(self, a, root=0): return a


def test_reduce_one_rank_and_reference_fault():
	"""pixell_tpu/utils.py:2873: reduce calls comm.Reduce, which neither
	package's communicator had (AttributeError on two ranks); one rank
	gives a copy in both. The port's TorchCommunicator has Reduce (two
	ranks: test_two_ranks)."""
	v = np.arange(6.0).reshape(2, 3)
	for comm in (None, FakeCommunicator()):
		got = utils.reduce(v, comm)
		match(got, jutils.reduce(v, comm), True)
		assert got is not v
	with pytest.raises(AttributeError):
		jutils.reduce(v, StubComm())
	assert hasattr(TorchCommunicator, "Reduce")


def redistribute_want(oboxes):
	"""The global array of the redistribute case cut to oboxes, columns wrapped."""
	g = W.redist_global()
	return [g[:, b[0][0]:b[0][1]][:, :, np.arange(b[1][0], b[1][1]) % g.shape[2]] for b in oboxes]


def test_redistribute_one_rank():
	"""pixell_tpu/utils.py:2894: the reference intersects [1, ndim, 3]
	stacks with sbox_intersect, which takes one box, and raises on any
	input; the port's one rank holds the global array's slices: with the
	array in one piece or in the worker's four, wrapped in columns."""
	g = W.redist_global()
	with pytest.raises((ValueError, IndexError)):
		jutils.redistribute([g], [[[0, 12], [0, 20]]], [[[1, 3], [2, 5]]], None)
	oboxes = W.REDIST_OBOXES[0] + W.REDIST_OBOXES[1]
	want = redistribute_want(oboxes)
	ib = W.REDIST_IBOXES[0] + W.REDIST_IBOXES[1]
	pieces = [g[(slice(None),) + tuple(slice(*d) for d in b)] for b in ib]
	for iarrs, iboxes in (([g], [[[0, 12], [0, 20]]]), (pieces, ib)):
		got = utils.redistribute(iarrs, iboxes, oboxes, None, wrap=[0, 20])
		match(got, want, True)
	# steps given, a box without wrap: the same
	got = utils.redistribute([g], [[[0, 12, 1], [0, 20, 1]]], [[[3, 5, 1], [4, 9, 1]]], None)
	match(got, [g[:, 3:5, 4:9]], True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
	return W.spawn(tmp_path_factory.mktemp("utils_ranks"), ["utils"], world=2).result()


def test_two_ranks(ranks):
	"""reduce over two gloo ranks against numpy's sum (and maximum) of the
	ranks' arrays, None off the root; redistribute against the one-rank
	result on the same global array."""
	v = [np.arange(6.0).reshape(2, 3)*(r + 1) + r for r in range(2)]
	for root in range(2):
		match(ranks["utils/reduce_sum_root%d" % root], v[0] + v[1], True)
		match(ranks["utils/reduce_max_root%d" % root], np.maximum(v[0], v[1]), True)
		for op in ("sum", "max"): assert ranks["utils/reduce_%s_root%d_others_none" % (op, root)]
	g = W.redist_global()
	for r in range(2):
		want = utils.redistribute([g], [[[0, 12], [0, 20]]], W.REDIST_OBOXES[r], None, wrap=[0, 20])
		for i, w in enumerate(want):
			match(ranks["utils/redistribute_rank%d_%d" % (r, i)], w, True)


def test_kept_quirks():
	"""Kept and shared with the reference: range_sub's third element is
	None (:1571); to_Nd reads only whether axis is 0 (:2097); a
	declination in (-1, 0) degrees loses its sign in jname and
	format_sexa (:2458, :2447); call_help drops no None (:2603,
	test_identity_helpers)."""
	for u in (utils, jutils):
		assert u.range_sub([[0, 10]], [[2, 3]], mapping=True)[2] is None
		a = np.zeros((2, 3, 4))
		assert u.to_Nd(a, 2, axis=1).shape == u.to_Nd(a, 2, axis=-1).shape == (2, 12)
		assert u.to_Nd(a[0, 0], 3, axis=2).shape == (4, 1, 1)
		assert u.jname(np.radians(10.0), np.radians(-0.3)) == "J004000+01800"
		assert u.format_sexa(-0.5) == "+00:30:000.00"
