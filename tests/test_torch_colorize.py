"""pixell_tpu_torch.colorize and .colors against pixell_tpu's: the RGBA
bytes equal to the reference's, bit for bit, for every scheme (the
matplotlib ones too, installed here) in the scalar mode, and in the direct
modes with 3 and 4 channels; float32 and float64 values, values outside
[0, 1], exactly on the nodes, NaN and +-inf; host input giving numpy and a
tensor giving a tensor. Also Colorscheme.reverse, "p:rrggbbaa" and "mpl:"
descriptions, and to_mpl_colormap.

The one scheme whose nodes are not sorted, "nozero" (0.4 after 0.500002),
is held against the reference's lookup of each value on its own: numpy's
vectorised searchsorted starts each search where the previous value's
ended, so the reference's colour of a pixel there depends on the pixel
before it (ROADMAP Queue 3); the test shows that too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import colorize as jcolorize, colors as jcolors
from pixell_tpu_torch import colorize, colors

SCHEMES = sorted(jcolorize.schemes)
UNSORTED = {"nozero"}


def values(dtype, seed=0):
	"""Values across and beyond [0, 1], the nodes of every scheme exactly,
	and the non-finite ones."""
	rng = np.random.default_rng(seed)
	nodes = np.concatenate([colorize.Colorscheme(s).vals for s in SCHEMES])
	x = np.concatenate([rng.uniform(-0.5, 1.5, 3000), nodes, [0, 1, -1e-300, 1 + 1e-15],
		[np.nan, np.inf, -np.inf, np.nan]])
	return x.astype(dtype)


def one_at_a_time(x, desc):
	"""The reference's scalar lookup of each value alone."""
	return np.array([jcolorize.colorize_scalar_python(np.array([v]), jcolorize.Colorscheme(desc))[0] for v in x])


def test_schemes_and_colors_are_the_references():
	assert list(colorize.schemes) == list(jcolorize.schemes)
	for name in SCHEMES:
		a, b = jcolorize.Colorscheme(name), colorize.Colorscheme(name)
		assert np.array_equal(a.vals, b.vals) and np.array_equal(a.cols, b.cols)
		assert a.cols.dtype == b.cols.dtype == np.uint8
	names = [n for n in dir(jcolors) if not n.startswith("_")]
	assert all(getattr(colors, n) == getattr(jcolors, n) for n in names)
	assert colorize.has_fortran is False


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SCHEMES)
def test_scalar_mode(name, dtype):
	x = values(dtype).reshape(2, -1)   # [2, n]: the shape comes back with a colour axis
	got = colorize.colorize(x, name)
	assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == x.shape + (4,)
	if name in UNSORTED:
		want = one_at_a_time(x.reshape(-1), name).reshape(got.shape)
		assert not np.array_equal(jcolorize.colorize(x, name), want)   # the reference's order dependence
	else:
		want = jcolorize.colorize(x, name)
	np.testing.assert_array_equal(got, want)
	# a tensor gives a tensor, the same bytes
	t = colorize.colorize(torch.from_numpy(x), name)
	assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
	np.testing.assert_array_equal(t.numpy(), want)
	# non-finite values fully transparent
	bad = ~np.isfinite(x)
	assert (got[bad] == 0).all() and bad.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nc", [3, 4])
@pytest.mark.parametrize("mode", ["direct", "direct_colorcap"])
def test_direct_modes(mode, nc, dtype):
	rng = np.random.default_rng(nc)
	x = rng.uniform(-0.3, 1.4, (nc, 20, 30)).astype(dtype)
	x[0, 0, :4] = [np.nan, np.inf, -np.inf, 1.0]
	x[1, 1, :3] = [np.nan, np.inf, -np.inf]
	x[:, 2, :3] = np.linspace(0, 1, 3)   # on the range's ends and middle
	with np.errstate(invalid="ignore"):
		want = jcolorize.colorize(x, mode=mode)
	got = colorize.colorize(x, mode=mode)
	assert got.shape == (20, 30, 4)
	np.testing.assert_array_equal(got, want)
	np.testing.assert_array_equal(colorize.colorize(torch.from_numpy(x), mode=mode).numpy(), want)


def test_descriptions_and_reverse():
	x = values(np.float64)
	for desc in ["0:ff0000ff,0.3:00ff0080,1:0000ff", "0:000000,1:ffffff", "0.5:123456",
			"mpl:magma", "mpl:twilight"]:
		np.testing.assert_array_equal(colorize.colorize(x, desc), jcolorize.colorize(x, desc))
	for name in ["planck", "wmap", "viridis", "hotcold2"]:
		r, jr = colorize.Colorscheme(name).reverse(), jcolorize.Colorscheme(name).reverse()
		assert np.array_equal(r.vals, jr.vals) and np.array_equal(r.cols, jr.cols)
		np.testing.assert_array_equal(colorize.colorize(x, r), jcolorize.colorize(x, jr))
		np.testing.assert_array_equal(r(x), jr(x))
	# cmap= and method= as the reference takes them
	np.testing.assert_array_equal(colorize.colorize(x, cmap="gray", method="x"),
		jcolorize.colorize(x, cmap="gray", method="x"))
	with pytest.raises(ValueError):
		colorize.colorize(x, mode="nonsense")


def test_matplotlib_interop():
	import matplotlib
	for name in ["planck", "viridis"]:
		a, b = colorize.to_mpl_colormap(name), jcolorize.to_mpl_colormap(name)
		t = np.linspace(0, 1, 257)
		np.testing.assert_array_equal(a(t), b(t))
	colorize.mpl_register("planck")
	assert "planck" in matplotlib.colormaps


def test_large_input_in_chunks(monkeypatch):
	"""The lookup in pixel chunks (CHUNK, small here) gives the bytes of one
	pass."""
	x = values(np.float32, seed=3)
	want = jcolorize.colorize(x, "planck")
	monkeypatch.setattr(colorize, "CHUNK", 97)
	np.testing.assert_array_equal(colorize.colorize(x, "planck"), want)
	d = np.stack([x, x[::-1], x])
	np.testing.assert_array_equal(colorize.colorize(torch.from_numpy(d), mode="direct").numpy(),
		jcolorize.colorize(d, mode="direct"))
