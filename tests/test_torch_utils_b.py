"""pixell_tpu_torch.utils' names of pixell_tpu/utils.py:1035-1950 (lists
and search, time scales, statistics and shaping, files and periods, ranges
and bins, boxes, gcd ... minmax) against the reference on the same numpy
inputs, made from seeds: integers, booleans, strings, shapes and
structures exactly, float64 results within 1e-12 relative to the largest
value. The helpers that take tensors also run on CPU tensors, against the
reference's numpy result at the same tolerances, and must answer with
tensors on the input's device. The file helpers run in tmp_path."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import utils as jutils
from pixell_tpu_torch import utils

REL = 1e-12


def host(x):
	"""x with tensors as numpy arrays, containers walked."""
	if isinstance(x, torch.Tensor): return x.numpy()
	if isinstance(x, (list, tuple)): return type(x)(host(v) for v in x)
	if isinstance(x, dict): return {k: host(v) for k, v in x.items()}
	return x


def match(got, want, exact):
	"""got equals want in structure, shape and (integer, boolean, string)
	values exactly; float values exactly or within REL of the largest."""
	if isinstance(want, (list, tuple)):
		assert isinstance(got, (list, tuple)) and len(got) == len(want), (got, want)
		for g, w in zip(got, want): match(g, w, exact)
		return
	if isinstance(want, dict):
		assert got.keys() == want.keys()
		for k in want: match(got[k], want[k], exact)
		return
	if want is None or isinstance(want, (str, bool)):
		assert got == want and type(got) is type(want), (got, want)
		return
	g, w = np.asarray(got), np.asarray(want)
	assert g.shape == w.shape, (g.shape, w.shape)
	if w.dtype.kind in "biuUSO" or exact:
		assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
		np.testing.assert_array_equal(g, w)
		return
	assert g.dtype.kind in "fc", g.dtype
	np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
	ok = np.isfinite(w)
	scale = np.abs(w[ok]).max() if ok.any() else 0
	assert np.abs(g[ok] - w[ok]).max(initial=0) <= REL*(scale if scale else 1)


rng = np.random.default_rng(1035)
X = rng.standard_normal((3, 7, 9))
XI = rng.integers(0, 6, (4, 11))
MASK = rng.random((5, 8)) < 0.4
MASK[1] = False
RANGES = np.array([[0, 10], [30, 35], [12, 20], [18, 25], [40, 40]])
BOXES = np.array([[[0, 1], [3, 5]], [[-2, 2], [1, 4]], [[0.5, -1], [2.5, 3]]])

# (name, args, kwargs, exact): host helpers, called with the same numpy inputs
HOST = [
	("l2ang", (np.arange(1, 50.0),), {}, False),
	("ang2l", (np.linspace(0.01, 1, 20),), {}, False),
	("listsplit", ([1, 0, 2, 3, 0, 0, 4],), {"elem": 0}, True),
	("listsplit", ("a,b,,c", ","), {}, True),
	("streq", ("abc", "abc"), {}, True),
	("streq", (np.array([1]), "abc"), {}, True),
	("find_any", ([5, 3, 1, 7, 9], [1, 7, 2]), {}, True),
	("find_any", ([1, 3, 5, 7], [7, 1]), {"sorted": True}, True),
	("find_range", (RANGES[:4], [3, 11, 19, 31, 50, -1]), {}, True),
	("find_range", (RANGES[:2], [3, 33, 20]), {"sorted": True, "default": -7}, True),
	("nearest_ind", ([1.0, 5.0, 3.0, 9.0], [2.9, 4.1, 100, -3, 7.0]), {}, True),
	("nearest_ind", ([1.0, 3.0, 5.0], [2.0, 4.5]), {"sorted": True}, True),
	("contains", (XI, [1, 4]), {}, True),
	("asfarray", ([1, 2, 3],), {}, True),
	("asfarray", (np.arange(3, dtype=np.float32),), {}, True),
	("asfarray", ([1, 2],), {"default_dtype": np.float32}, True),
	("common_vals", ([[1, 2, 3, 5], [5, 3, 9], [3, 5, 5]],), {}, True),
	("common_inds", ([[1, 2, 3, 5], [5, 3, 9], [3, 5, 5, 8]],), {}, True),
	("union", ([[1, 2], [5, 3, 9], [3, 0]],), {}, True),
	("inverse_order", (rng.permutation(13),), {}, True),
	("complement_inds", ([1, 3, 7], 9), {}, True),
	("complement_inds", (None, 4), {}, True),
	("dict_lookup", ({1: [1, 2], 2: [3, 4], 5: [0, 9]}, [[1, 2], [5, 1]]), {}, True),
	("fallback", (None, None, 3, 4), {}, True),
	("cumsplit", ([1, 2, 3, 4, 5], [3, 3, 4, 10]), {}, True),
	("mask2range", (MASK[0],), {}, True),
	("mask2range", (np.ones(5, bool),), {}, True),
	("repeat_filler", ([1, 2, 3], 8), {}, True),
	("repeat_filler", (np.arange(4.0), 3), {}, True),
	("repeat", (XI[:2, :3], 3), {}, True),
	("repeat", (XI[:2, :3], 2), {"axis": 0}, True),
	("mjd2djd", (np.array([50000.5, 60000.25]),), {}, True),
	("djd2mjd", (np.array([40000.5, 45000.75]),), {}, True),
	("mjd2jd", (np.array([50000.5]),), {}, True),
	("jd2mjd", (2460000.5,), {}, True),
	("djd2ctime", (np.array([43000.1, 45000.9]),), {}, True),
	("ctime2jd", (np.array([1.6e9, 1.7e9]),), {}, True),
	("jd2ctime", (2460000.5,), {}, True),
	("yr2ctime", (np.array([2020.5, 1999.0]),), {}, True),
	("ctime2yr", (np.array([1.6e9, 0.0]),), {}, True),
	("ctime2date", (1.6e9,), {}, True),
	("ctime2date", (1.6e9, 5.5, "%Y-%m-%d %H:%M:%S"), {}, True),
	("date2ctime", ("2020-09-13 12:26:40",), {}, True),
	("date2ctime", (" 2021-03-04T05:06:07",), {}, True),
	("date2ctime", ("1999-12-31",), {}, True),
	("search", (np.sort(X[0], -1), X[0, :, 3]), {}, True),
	("search", (np.sort(X[0], -1), X[0, :, 3]), {"side": "right"}, True),
	("dedup", ([1, 1, 2, 2, 2, 3, 1, 1],), {}, True),
	("dedup", (np.zeros(0),), {}, True),
	("grid", ([[0, 1], [2, 5]], (3, 4)), {}, False),
	("grid", ([[0, 1, -1], [2, 5, 1]], (3, 4, 2)), {"endpoint": False, "axis": -1}, False),
	("grid", ([0, 1], (5,)), {"flat": True}, False),
	("nearest_product", (100, [2, 3, 5]), {}, True),
	("nearest_product", (1000, [2, 3, 5, 7]), {"direction": "above"}, True),
	("nearest_product", (97.5, [7]), {}, True),
	("nearest_product", (17, [1, 2]), {}, True),
	("decomp_basis", (rng.standard_normal((3, 8)), rng.standard_normal((2, 8))), {}, False),
	("find_period_fourier", (np.sin(np.arange(400)/7.0)[None]*[[1], [2]],), {}, False),
	("find_sweeps", (jutils.triangle_wave(np.arange(300)/40.0) + 0.01*rng.standard_normal(300),), {}, True),
	("equal_split", ([3, 1, 4, 1, 5, 9, 2, 6], 3), {}, True),
	("range_normalize", ([[3, 1], [2, 2], [0, 5], [7, 9]],), {}, True),
	("range_normalize", (np.zeros((0, 2), int),), {}, True),
	("range_union", (RANGES,), {}, True),
	("range_union", (RANGES,), {"mapping": True}, True),
	("range_union", (np.zeros((0, 2), int),), {"mapping": True}, True),
	("range_sub", (RANGES[:3], [[5, 13], [31, 32]]), {}, True),
	("range_sub", (RANGES[:3], [[5, 13], [31, 32]]), {"mapping": True}, True),
	("range_sub", ([[0, 4]], []), {}, True),
	("range_cut", (RANGES[:3], [3, 7, 15, 33]), {}, True),
	("edges2bins", ([0, 3, 7, 12],), {}, True),
	("bins2edges", ([[0, 3], [3, 7], [7, 12]],), {}, True),
	("bin_expand", ([[0, 2], [2, 5], [5, 6]], X[0, :2, :3]), {}, True),
	("pad_bins", ([[0, 3], [3, 7], [7, 12]], 2), {}, True),
	("pad_bins", ([[0, 3], [3, 7], [7, 12]], 2), {"min": 0, "max": 10}, True),
	("merge_bins", (RANGES,), {}, True),
	("infer_bin_edges", ([1.0, 2.0, 3.5, 5.5],), {}, False),
	("infer_bin_edges", ([1.0, 2.0, 3.5, 5.5],), {"ref": 2}, False),
	("bounding_box", (BOXES,), {}, True),
	("bounding_box", (BOXES[:, 0],), {}, True),
	("box2corners", (BOXES[0],), {}, True),
	("box2corners", ([[0, 1, 2], [3, 4, 5]],), {}, True),
	("box2contour", ([[0, 0], [1, 2]],), {}, True),
	("box2contour", ([[0, 0], [1, 2]], 3), {}, True),
	("box_area", (BOXES,), {}, True),
	("box_slice", (BOXES[0], BOXES), {}, True),
	("box_overlap", (BOXES[0], BOXES), {}, True),
	("widen_box", (BOXES[1],), {}, True),
	("pad_box", ([[1, 3], [0, 0]], 0.5), {}, True),
	("unwrap_range", ([[0, 7], [1, 2]],), {}, False),
	("unwrap_range", ([5.0, 1.0],), {}, False),
	("unwrap_range", ([370.0, 10.0],), {"nwrap": 360}, False),
	("pole_wrap", ([[2.0, -2.0, 0.3, 5.0], [0.1, 0.2, 0.3, 0.4]],), {}, False),
	("tuplify", ([1, 2],), {}, True),
	("tuplify", (3,), {}, True),
	("iorlast", ([1, 2, 3], 1), {}, True),
	("iorlast", ([1, 2, 3], 7), {}, True),
	("iorlast", (5, 2), {}, True),
	("gcd", (462, 1071), {}, True),
	("lcm", (21, 6), {}, True),
	("uncat", (np.arange(10), [2, 5, 3]), {}, True),
	("label_unique", (np.array([[1, 2], [1, 2.0000001], [3, 4.0], [1, 2]]),), {"axes": (1,)}, True),
	("label_unique", (np.array([1.0, 1.1, 1.0, 2.0]),), {"rtol": 0.2}, True),
	("transpose_inds", ([0, 5, 7, 11], 3, 4), {}, True),
	("split_by_group", ("a(b(c)d)e[f]g", "([", ")]"), {}, True),
	("split_outside", ("a,b(c,d),[e,f],g", ","), {}, True),
	("replace_outside", ("a", "X", "ab(a)a[aa]"), {}, True),
	("find_equal_groups_fast", (XI[0],), {}, True),
	("find_similar_groups_fast", (np.array([1.0, 1.05, 3.0, 1.1, 5.0, 3.02]),), {"tol": 0.06}, True),
	("label_similar_groups_fast", (np.array([1.0, 1.05, 3.0, 1.1, 5.0, 3.02]),), {"tol": 0.06}, True),
	("label_multi", ([[1, 1, 2, 1], [3, 3, 3, 4]],), {}, True),
	("label_multi", ([[1, 1, 2, 1], [3, 3, 3, 4]], True, True), {}, True),
	("pathsplit", ("/a/b/c.txt",), {}, True),
	("pathsplit", ("a/b/",), {}, True),
	("pathsplit", ("rel",), {}, True),
]


@pytest.mark.parametrize("case", range(len(HOST)), ids=lambda i: "%s-%d" % (HOST[i][0], i))
def test_host(case):
	name, args, kw, exact = HOST[case]
	match(getattr(utils, name)(*args, **kw), getattr(jutils, name)(*args, **kw), exact)


# (name, args, kwargs, exact): the helpers that take tensors; every numpy
# array among args becomes a CPU tensor for the tensor run
TENSOR = [
	("find_first", (MASK,), {}, True),
	("find_first", (MASK,), {"axis": 0, "default": 99}, True),
	("find_last", (MASK,), {}, True),
	("find_last", (MASK,), {"axis": 0}, True),
	("unmask", (X[0][:, :8][:, MASK[2]], MASK[2]), {"axis": 1}, True),
	("unmask", (np.arange(int(MASK.sum())), MASK), {"fill": -1}, True),
	("argmax", (X,), {}, True),
	("argmin", (X,), {}, True),
	("medmean2", (X,), {}, False),
	("medmean2", (X,), {"axis": -1}, False),
	("medmean2", (X,), {"axis": 1, "frac": 0.3}, False),
	("medmean2", (XI,), {"axis": 0}, False),
	("maskmed", (np.where(MASK, 0, X[0, :5, :8]),), {}, False),
	("maskmed", (np.where(MASK, 0, X[0, :5, :8]),), {"axis": 0}, False),
	("maskmed", (X[0, :5, :8], ~MASK), {"maskval": -3}, False),
	("maskmed", (np.where(MASK, 0, X[0, :5, :8])[:, :7],), {}, False),
	("moveaxes", (X, [0, 1], [2, 0]), {}, True),
	("moveaxes", (X, 0, -1), {}, True),
	("weighted_quantile", (X, np.abs(X[::-1]) + 0.1, 0.3), {}, False),
	("weighted_quantile", (X, np.abs(X[::-1]) + 0.1, 0.8), {"axis": 1}, False),
	("weighted_quantile", (X, 1.0, 0.0), {}, False),
	("weighted_quantile", (X, np.where(X > 0, 0.0, 1.0), 0.97), {}, False),
	("weighted_median", (X,), {}, False),
	("weighted_median", (X, np.abs(X) + 1), {"axis": 0}, False),
	("partial_flatten", (X,), {}, True),
	("partial_flatten", (X, [0]), {"pos": 1}, True),
	("partial_flatten", (X, [2, 0]), {}, True),
	("partial_expand", (X.reshape(21, 9),), {"shape": (3, 7, 9)}, True),
	("partial_expand", (np.transpose(X, (1, 2, 0)).reshape(63, 3).T,), {"shape": (3, 7, 9), "axes": [0], "pos": 1},
		True),
	("addaxes", (X, [0, -1]), {}, True),
	("addaxes", (X[0], [1]), {}, True),
	("delaxes", (X[:1, :, None, :], [0, 2]), {}, True),
	("bin_multi", (np.array([XI[0], XI[1] - 1]), (5, 4)), {}, True),
	("bin_multi", (np.array([XI[0], XI[1]]), (6, 6)), {"weights": X.reshape(-1)[:11]}, False),
	("bincount", (XI[0],), {}, True),
	("bincount", (XI[0],), {"weights": X.reshape(-1)[:11], "minlength": 9}, False),
	("bincount", (XI,), {}, True),
	("bincount", (XI,), {"weights": X.reshape(-1)[:11]}, False),
	("bincount", (XI.reshape(2, 2, 11),), {"weights": X.reshape(-1)[:44].reshape(2, 2, 11), "minlength": 8}, False),
	("pixwin_1d", (np.linspace(-0.5, 0.5, 41),), {}, False),
	("pixwin_1d", (np.linspace(-0.5, 0.5, 41),), {"order": "lin"}, False),
	("pixwin_1d", (np.linspace(-0.5, 0.5, 41),), {"order": None}, True),
	("sum_by_id", (X[:, :, 0], [0, 2, 0]), {}, False),
	("sum_by_id", (X[0], XI[0, :9]), {"axis": 1}, False),
	("sum_by_id", (XI, [1, 1, 0, 3]), {}, True),
	("resize_array", (XI, [6, 4]), {}, True),
	("resize_array", (XI, 15), {"axis": 1, "val": -2}, True),
	("resize_array", (X, [2, 12]), {"axis": [0, 2]}, True),
	("vec_angdist", (X[:, :, 0], X[:, :, 1]), {}, False),
	("vec_angdist", (X[:, 0], X[:, 0]*3), {}, False),
	("vec_angdist", (X[0, :3], -X[0, :3]), {"axis": 1}, False),
	("rescale", (X,), {}, True),
	("rescale", (XI,), {"range": [-1, 3]}, True),
	("rescale", (np.ones(4),), {}, True),
	("minmax", (X,), {}, True),
	("minmax", (X,), {"axis": 1}, True),
	("minmax", (XI,), {"axis": -1}, True),
]


def tensorize(x):
	if isinstance(x, np.ndarray): return torch.from_numpy(x.copy())
	if isinstance(x, tuple): return tuple(tensorize(v) for v in x)
	if isinstance(x, dict): return {k: tensorize(v) for k, v in x.items()}
	return x


def tensors_on(x, device):
	"""Every leaf of x is a tensor on device (a shape, a tuple of ints, aside)."""
	if isinstance(x, tuple) and x and all(type(v) is int for v in x): return True
	if isinstance(x, (list, tuple)): return all(tensors_on(v, device) for v in x)
	return isinstance(x, torch.Tensor) and x.device == torch.device(device)


@pytest.mark.parametrize("case", range(len(TENSOR)), ids=lambda i: "%s-%d" % (TENSOR[i][0], i))
def test_tensor_helpers(case):
	"""Each helper on numpy against the reference, then on CPU tensors:
	tensors on the CPU, the reference's values."""
	name, args, kw, exact = TENSOR[case]
	with np.errstate(all="ignore"):
		want = getattr(jutils, name)(*args, **kw)
	match(getattr(utils, name)(*args, **kw), want, exact)
	got = getattr(utils, name)(*tensorize(args), **tensorize(kw))
	assert tensors_on(got, "cpu"), type(got)
	match(host(got), want, exact)


def test_flatview():
	"""flatview on numpy and on a tensor: the flat view, written through."""
	for arr in (X.copy(), torch.from_numpy(X.copy())):
		ref = X.copy()
		with jutils.flatview(ref, axes=[1]) as f: f *= 2
		with utils.flatview(arr, axes=[1]) as f:
			assert tuple(f.shape) == (27, 7)
			f *= 2
		match(host(arr), ref, True)
		with utils.flatview(arr, axes=[1], mode="r") as f: f *= 0
		match(host(arr), ref, True)


def test_derivative_and_nowarn():
	f = lambda x: np.sin(x)*x**2
	x = np.linspace(-2, 2, 17)
	match(utils.D(f)(x), jutils.D(f)(x), True)
	match(utils.D(f, eps=1e-20)(x), jutils.D(f, eps=1e-20)(x), True)
	with utils.nowarn():
		import warnings
		warnings.warn("hidden")
		np.ones(2)/0
	assert np.geterr()["divide"] != "ignore"


def test_files(tmp_path):
	"""lines, touch, mkdir, symlink in tmp_path, as the reference."""
	fn = tmp_path/"a.txt"
	fn.write_text("one\ntwo\n\nthree")
	assert list(utils.lines(str(fn))) == list(jutils.lines(str(fn)))
	with open(fn) as f: assert list(utils.lines(f)) == ["one\n", "two\n", "\n", "three"]
	t = tmp_path/"t"
	utils.touch(str(t))
	assert t.exists() and t.stat().st_size == 0
	os.utime(t, (1, 1))
	utils.touch(str(t))
	assert t.stat().st_mtime > 1
	d = tmp_path/"x"/"y"/"z"
	utils.mkdir(str(d)); utils.mkdir(str(d))
	assert d.is_dir()
	link = tmp_path/"link"
	utils.symlink(str(fn), str(link))
	utils.symlink(str(tmp_path/"t"), str(link))
	assert os.readlink(link) == str(tmp_path/"t")


def test_dict_apply_and_find_period():
	d = {"a": 3, "b": 1, "c": 2}
	assert utils.dict_apply_listfun(d, sorted) == jutils.dict_apply_listfun(d, sorted)
	t = np.arange(600)
	sig = np.array([np.sin(2*np.pi*t/37.3), np.cos(2*np.pi*t/51.0 + 0.4)])
	match(utils.find_period(sig), jutils.find_period(sig), False)
	match(utils.find_period_exact(sig[0], 37.0), jutils.find_period_exact(sig[0], 37.0), False)


def test_medmean2_bsize_and_weighted_quantile_ties():
	"""medmean2 ignores bsize, as the reference; weighted_quantile on ties
	with equal weights gives one answer for any order of the ties."""
	match(utils.medmean2(X, axis=2, bsize=3), jutils.medmean2(X, axis=2), False)
	v = np.repeat(np.arange(5.0), 3)[None]
	for q in (0.1, 0.5, 0.9):
		want = jutils.weighted_quantile(v, 1, q)
		match(utils.weighted_quantile(torch.from_numpy(v), 1, q).numpy(), want, False)
