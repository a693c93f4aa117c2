"""pixell_tpu_torch.enplot and .cgrid against pixell_tpu's: the colour
range equal to the reference's exactly (float32 and float64 maps, NaN,
symmetric or not); enplot.plot's images equal pixel for pixel, with equal
plot names, for the options the reference's own tests use
(tests/test_support.py:39-46, :242-276) and a few more; write's PNG bytes
equal; map_to_color's bytes equal; the option parser's flags equal; and
cgrid.calc_gridinfo's segments within 1e-12. The maps are CPU tensors,
which take every step of the card's path but the kernels (none here)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, enplot as jenplot, cgrid as jcgrid, utils as jutils
from pixell_tpu_torch import enmap, enplot, cgrid, utils


def pair(shape_pre, res_deg, seed, dtype=np.float64):
	"""The same random full-sky map for the reference and the port."""
	shape, wcs = jenmap.fullsky_geometry(res=res_deg*jutils.degree)
	pshape, pwcs = enmap.fullsky_geometry(res=res_deg*utils.degree)
	assert tuple(pshape) == tuple(shape)
	arr = np.random.default_rng(seed).standard_normal(shape_pre + shape).astype(dtype)
	return jenmap.ndmap(arr, wcs), enmap.ndmap(torch.from_numpy(arr.copy()), pwcs), arr


def same_plots(a, b):
	assert len(a) == len(b) > 0
	for x, y in zip(a, b):
		assert x.name == y.name
		assert x.type == y.type
		np.testing.assert_array_equal(np.asarray(y.img), np.asarray(x.img))
		np.testing.assert_array_equal(np.asarray(y.info.crange), np.asarray(x.info.crange))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("quantile", [0.01, 0.1, 0.37, 0.5, 0.0])
def test_get_color_range(dtype, symmetric, quantile):
	rng = np.random.default_rng(7)
	arr = (rng.standard_normal((37, 53))*3 + 1).astype(dtype)
	arr[3, :5] = np.nan
	arr[4, 2] = np.inf
	want = jenplot.get_color_range(arr, quantile, symmetric)
	for a in (torch.from_numpy(arr), arr):
		got = enplot.get_color_range(a, quantile, symmetric)
		assert got.dtype == want.dtype == np.float64
		np.testing.assert_array_equal(got, want)
	# no finite value; one finite value
	nan = np.full((3, 4), np.nan, dtype)
	np.testing.assert_array_equal(enplot.get_color_range(torch.from_numpy(nan)), jenplot.get_color_range(nan))
	nan[1, 1] = 2.5
	np.testing.assert_array_equal(enplot.get_color_range(torch.from_numpy(nan), quantile, symmetric),
		jenplot.get_color_range(nan, quantile, symmetric))


@pytest.mark.parametrize("args", ["-b --ticks 45 --contours 1.0", "", "-d 2 -g", "-r 1.5 -c wmap",
	"--min -1 --max 2 -c gray", "-q 0.1 --nolabels --grid-color ff000080 -t 30,60"])
def test_plot_single(args):
	"""A 36 x 72 full-sky map (5 degrees)."""
	jm, m, _ = pair((), 5, 2)
	same_plots(jenplot.plot(jm, args), enplot.plot(m, args))


@pytest.mark.parametrize("args", ["--rgb", "--prefix x_ --ext png", "--tile 1,3", "--slice 0 --op m*0+1 -g",
	"-L --ticks 45", "--reverse-color", "-D mpl -b", "-r 1:2:3", "--tile -1 --tile-transpose",
	"--op2 'm=np.abs(m)' -c hotcold", "--sub=-30:30,60:-60 --rgb --rgb-mode direct_colorcap"])
def test_plot_components(args):
	"""Three components on the 18 x 36 full sky (10 degrees)."""
	jm, m, _ = pair((3,), 10, 3)
	same_plots(jenplot.plot(jm, args), enplot.plot(m, args))


@pytest.mark.parametrize("args", ["-u 3 -g", "-D mpl -b", "--annotate ANN --ticks 30"])
def test_plot_first_component(args, tmp_path):
	jm, m, _ = pair((3,), 10, 3)
	if "ANN" in args:
		ann = tmp_path/"ann.txt"
		ann.write_text("c 0 0 0 0 5 2 ff0000\nt 20 -30 0 0 hello 1 00ff00\nl -40 40 0 0 40 -40 0 0 2 blue\n"
			"p 10 10 0 0\nc 30 100 6\nt -10 -100 short text\n")
		args = args.replace("ANN", str(ann))
	same_plots(jenplot.plot(jm[0], args), enplot.plot(m[0], args))


@pytest.mark.parametrize("args", ["-S", "-S --tile 1,3", "-A", "-d 2,3 -z", "--pos-ra -g -F", "STAMPS",
	"--slice 0,1 -u 2,3 -g -t 10", "-c mpl:magma --no-image", "--sub=-10:10,20:-20 -b --font-size 20"])
def test_plot_patch_matrix(args, tmp_path):
	"""A [2, 2] matrix of maps on a 40 x 80 degree patch (2 degrees):
	symmetric triangles, crops, stamps at a catalogue's positions."""
	box = np.array([[-20, 40], [20, -40]])
	shape, wcs = jenmap.geometry(pos=box*jutils.degree, res=2*jutils.degree)
	pshape, pwcs = enmap.geometry(pos=box*utils.degree, res=2*utils.degree)
	arr = np.random.default_rng(5).standard_normal((2, 2) + tuple(shape))
	if args == "STAMPS":
		np.savetxt(tmp_path/"srcs.txt", np.array([[0.0, 0.0], [5.0, 10.0], [-3, -12]]))
		args = "--stamps %s:6" % (tmp_path/"srcs.txt")
	same_plots(jenplot.plot(jenmap.ndmap(arr, wcs), args), enplot.plot(enmap.ndmap(torch.from_numpy(arr), pwcs), args))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plot_mask_and_nonempty(dtype):
	jm, m, arr = pair((3,), 10, 3, dtype)
	arr = arr.copy()
	arr[0] = 0
	arr[1, 3, 4] = np.nan
	arr[2, 5, :7] = 0.25
	wcs, pwcs = jm.wcs, m.wcs
	jm, m = jenmap.ndmap(arr, wcs), enmap.ndmap(torch.from_numpy(arr.copy()), pwcs)
	for args in ["-E -m 0", "-m 0.25 --mask-tol 1e-6", "", "-m 0.5 --mask-tol 0.3 -a"]:
		same_plots(jenplot.plot(jm, args), enplot.plot(m, args))


def test_write_png_bytes(tmp_path):
	jm, m, _ = pair((3,), 10, 3)
	for args in ["-b --ticks 45 --contours 1.0", "--tile 1,3"]:
		a = jenplot.write(str(tmp_path/"ref.png"), jenplot.plot(jm, args))
		b = enplot.write(str(tmp_path/"port.png"), enplot.plot(m, args))
		assert len(a) == len(b)
		for fa, fb in zip(a, b):
			assert open(fa, "rb").read() == open(fb, "rb").read()
	enplot.pwrite(str(tmp_path/"p.png"), m[0], "-g")
	jenplot.pwrite(str(tmp_path/"q.png"), jm[0], "-g")
	assert (tmp_path/"p.png").read_bytes() == (tmp_path/"q.png").read_bytes()


def test_map_to_color_and_helpers():
	jm, m, arr = pair((3,), 10, 3, np.float32)
	crange = jenplot.get_color_range(arr[0])
	for args in ["planck", enplot.parse_args("-c wmap")]:
		want = jenplot.map_to_color(jm, crange, args)
		got = enplot.map_to_color(m, crange, args)
		assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
		np.testing.assert_array_equal(got.numpy(), want)
	e1, e2 = jenplot.hwexpand(arr, ncol=2), enplot.hwexpand(torch.from_numpy(arr), ncol=2)
	np.testing.assert_array_equal(e2.numpy(), e1)
	np.testing.assert_array_equal(enplot.hwstack(e2).numpy(), jenplot.hwstack(e1))
	np.testing.assert_array_equal(enplot.hwexpand(arr, nrow=2, transpose=True), jenplot.hwexpand(arr, nrow=2,
		transpose=True))
	np.testing.assert_array_equal(enplot.calc_contours(crange, enplot.parse_args("-C 0.5")),
		jenplot.calc_contours(crange, jenplot.parse_args("-C 0.5")))
	assert enplot.parse_range("1:2", 3).tolist() == jenplot.parse_range("1:2", 3).tolist()
	assert enplot.split_file_name("a/b.c.fits") == jenplot.split_file_name("a/b.c.fits")
	assert enplot.build_oname(enplot.parse_args("--odir out --suffix _s"), comp="_1", fname="d/m.fits") == \
		jenplot.build_oname(jenplot.parse_args("--odir out --suffix _s"), comp="_1", fname="d/m.fits")
	np.testing.assert_array_equal(enplot.makefoot(3), jenplot.makefoot(3))
	gm, ginfo = enplot.get_map(m, enplot.parse_args("-d 2 --slice 1"), return_info=True)
	jgm, jinfo = jenplot.get_map(jm, jenplot.parse_args("-d 2 --slice 1"), return_info=True)
	np.testing.assert_array_equal(gm.data.numpy(), np.asarray(jgm))
	assert ginfo.ishape == jinfo.ishape


def test_option_parser():
	flags = lambda p: sorted(s for a in p._actions for s in a.option_strings)
	assert flags(enplot.define_arg_parser()) == flags(jenplot.define_arg_parser())
	dests = lambda p: {a.dest: a.default for a in p._actions}
	assert dests(enplot.define_arg_parser()) == dests(jenplot.define_arg_parser())
	assert dict(enplot.parse_args("-r 3 -c gray -g -g --rgb")) == dict(jenplot.parse_args("-r 3 -c gray -g -g --rgb"))


@pytest.mark.parametrize("res,steps", [(2, [10, 15]), (1, [7, 20])])
def test_calc_gridinfo(res, steps):
	"""On a 60 x 120 degree patch (on the full sky the reference's corners
	wrap to one RA, and it draws no meridian)."""
	box = np.array([[-30, 60], [30, -60]])
	shape, wcs = jenmap.geometry(pos=box*jutils.degree, res=res*jutils.degree)
	pshape, pwcs = enmap.geometry(pos=box*utils.degree, res=res*utils.degree)
	assert tuple(shape) == tuple(pshape)
	a = jcgrid.calc_gridinfo(shape, wcs, steps=steps, nstep=[50, 60])
	b = cgrid.calc_gridinfo(pshape, pwcs, steps=steps, nstep=[50, 60])
	for g in ("lat", "lon"):
		assert len(getattr(a, g)) == len(getattr(b, g)) > 0
		for (va, sa), (vb, sb) in zip(getattr(a, g), getattr(b, g)):
			assert va == vb
			assert sa.shape == sb.shape
			assert np.abs(sa - sb).max() <= 1e-12*max(1, np.abs(sa).max())
	assert [(l.name, l.val, l.text) for l in cgrid.calc_label_pos(b, pshape)] == \
		[(l.name, l.val, l.text) for l in jcgrid.calc_label_pos(a, shape)]
	segs = [s for _, s in b.lat]
	jsegs = [s for _, s in a.lat]
	for x, y in zip(cgrid.prune_bad_segs(cgrid.calc_line_segs(segs[0]), pshape),
			jcgrid.prune_bad_segs(jcgrid.calc_line_segs(jsegs[0]), shape)):
		np.testing.assert_allclose(x, y, rtol=0, atol=1e-12*max(1, np.abs(y).max()))
	assert cgrid.calc_bounds(np.array([[[-3, -2], [5, 7]]]), (4, 4)).tolist() == \
		jcgrid.calc_bounds(np.array([[[-3, -2], [5, 7]]]), (4, 4)).tolist()


def test_video_writer(tmp_path):
	"""VideoWriter gathers frames into one animated gif, as the reference's."""
	jm, m, _ = pair((3,), 10, 3)
	out = []
	for mod, mm, name in ((enplot, m, "port.gif"), (jenplot, jm, "ref.gif")):
		w = mod.VideoWriter(str(tmp_path/name), fps=5)
		for p in mod.plot(mm, ""):
			w.add(p)
		w.close()
		out.append((tmp_path/name).read_bytes())
	assert out[0] == out[1]


def test_plot_file(tmp_path):
	"""A map given by its file name, read onto the device given as the
	plot option device, and get_map's read: the reference's images and names."""
	jm, m, _ = pair((3,), 10, 3)
	fname = str(tmp_path/"m.fits")
	enmap.write_map(fname, m)
	same_plots(jenplot.plot(fname, "-g --ticks 45"), enplot.plot(fname, "-g --ticks 45", device="cpu"))
	opts = enplot.parse_args("--slice 1")
	opts.device = "cpu"
	g = enplot.get_map(fname, opts)
	np.testing.assert_array_equal(g.data.numpy(), np.asarray(jenplot.get_map(fname, jenplot.parse_args("--slice 1"))))
