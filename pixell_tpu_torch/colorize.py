"""Values to RGBA colours for map plots (counterpart of pixell_tpu/colorize.py).

The colour schemes are small host tables (node positions in [0, 1] and their
RGBA bytes). The per-pixel lookup runs in plain torch on the values' device:
a tensor gives a uint8 tensor there, anything else is looked up on a CPU
tensor and comes back as a numpy array. It computes what the reference's
numpy does, in float64 and in the same order of operations, so that the
bytes are the reference's bit for bit: the scalar mode finds each value's
interval by binary search (side left, clipped to [1, n-1]), interpolates
the two nodes' bytes and rounds half to even; the direct modes clip and
truncate. Non-finite values come out fully transparent. Divisions are of
two tensors, never by a Python number, which CUDA would do as a product
with its reciprocal.

The matplotlib schemes (viridis, plasma, cubehelix, cooltowarm) are sampled
at import where matplotlib is installed and left out silently where it is
not; to_mpl_colormap, mpl_register and mpl_setdefault import it when called.

One difference from the reference: a scheme whose nodes are not sorted
("nozero" has 0.4 after 0.500002) gets each value's binary search on its
own, where numpy's vectorised searchsorted starts each search from the
previous value's result, so the reference's colour of a pixel depends on
the pixel before it.
"""
from __future__ import annotations
import numpy as np
import torch

# The reference has no compiled colour driver either; both names run the
# same lookup (pixell_tpu/colorize.py:17).
has_fortran = False

CHUNK = 1 << 24   # pixels looked up at once: bounds the float64 temporaries on the card


class Colorscheme:
	"""A colour map: node positions vals in [0, 1] with their RGBA bytes
	cols (pixell_tpu.colorize.Colorscheme :20). desc is a registered name,
	a matplotlib colour map's name behind "mpl:", "p1:rrggbb[aa],p2:...", or
	another Colorscheme."""
	def __init__(self, desc):
		self.desc = desc
		if isinstance(desc, Colorscheme):
			self.vals, self.cols = desc.vals, desc.cols
			self.desc = desc.desc
			return
		if isinstance(desc, str) and desc in schemes:
			other = schemes[desc]
			if isinstance(other, Colorscheme):
				self.vals, self.cols = other.vals, other.cols
			else:
				self.vals, self.cols = _parse(other)
		elif isinstance(desc, str) and desc.startswith("mpl:"):
			self.vals, self.cols = _from_mpl(desc[4:])
		else:
			self.vals, self.cols = _parse(desc)
	def reverse(self):
		"""The scheme running the other way."""
		res = Colorscheme(self)
		res.vals = 1 - self.vals[::-1]
		res.cols = self.cols[::-1]
		return res
	def __call__(self, x):
		return colorize(x, self)


def _parse(desc):
	toks = desc.split(",")
	vals, cols = [], []
	for tok in toks:
		p, _, c = tok.partition(":")
		vals.append(float(p))
		c = c.strip()
		if len(c) == 6: c = c + "ff"
		cols.append([int(c[i:i+2], 16) for i in range(0, 8, 2)])
	return np.array(vals), np.array(cols, np.uint8)


def _from_mpl(name, n=256):
	"""A matplotlib colour map sampled at n evenly spaced nodes."""
	import matplotlib
	cmap = matplotlib.colormaps[name]
	x = np.linspace(0, 1, n)
	return x, (np.asarray(cmap(x))*255).astype(np.uint8)


schemes = {
	"planck": "0:0000ff,0.332:00d7ff,0.5:ffedd9,0.664:ffb400,0.828:ff4b00,1:640000",
	"planck_old": "0:0000ff,0.33:ffedd9,0.83:ff4b00,1:640000",
	"pcont":  "0:0000ff,0.332:00d7ff,0.5:00cc00,0.664:ffb400,0.828:ff4b00,1:640000",
	"pwhite": "0:0000ff,0.332:00d7ff,0.5:ffffff,0.55:ffedd9,0.664:ffb400,0.828:ff4b00,1:640000",
	"wmap":   "0:000080,0.15:0000ff,0.4:00ffff,0.7:ffff00,0.9:ff5500,1:800000",
	"nozero": "0:000080,0.15:0000ff,0.499998:55ffaa,0.499999:55ffaa00,0.500001:55ffaa00,0.500002:55ffaa,0.4:00ffff,0.7:ffff00,0.9:ff5500,1:800000",
	"gray":   "0:000000,1:ffffff",
	"grey":   "0:000000,1:ffffff",
	"hotcold": "0:0000ff,0.5:000000,1:ff0000",
	"hotcold2": "0:0000ff,0.5:ffffff,1:ff0000",
	"reddish": "0:000000,0.5:b60000,0.7:ff6500,0.75:ff7f00,1:ffffff",
	"phase":  "0:ff0000,0.25:ffff00,0.5:00ff00,0.75:00ffff,1:ff0000",
	"iron":   "0:000000,0.12:1b0080,0.25:8b009d,0.45:d92961,0.6:f37101,0.78:fec300,0.9:ffee58,1:fffff9",
	"comap":  "0:723959,0.2:4e7cb2,0.4:9dd5cd,0.5:cde1af,0.6:d2c673,0.8:9b5b2c,1:733957",
}


def _register_mpl_schemes():
	try:
		for ours, mpl in [("viridis", "viridis"), ("plasma", "plasma"),
				("cubehelix", "cubehelix"), ("cooltowarm", "coolwarm")]:
			vals, cols = _from_mpl(mpl)
			cs = Colorscheme("0:000000,1:ffffff")
			cs.vals, cs.cols, cs.desc = vals, cols, ours
			schemes[ours] = cs
	except Exception:   # no matplotlib: the schemes above only
		pass
_register_mpl_schemes()


def _as_values(arr):
	"""(tensor, host): arr as a tensor (a CPU tensor for host data) and
	whether the result goes back to numpy."""
	if hasattr(arr, "wcs"): arr = arr.data
	if isinstance(arr, torch.Tensor): return arr, False
	return torch.as_tensor(np.asarray(arr)), True


def _chunked(fun, a):
	"""fun over pixel chunks of a [N] (or a [ncomp, N]): [N, 4] uint8."""
	n = a.shape[-1]
	res = torch.empty((n, 4), dtype=torch.uint8, device=a.device)
	for i in range(0, max(n, 1), CHUNK):
		res[i:i+CHUNK] = fun(a[..., i:i+CHUNK])
	return res


def colorize(arr, desc="planck", mode="scalar", driver="auto", cmap=None, method=None):
	"""RGBA bytes of values (pixell_tpu.colorize.colorize :106): in mode
	"scalar" arr [...] -> [..., 4] through the scheme; in "direct" the
	channels arr [{r, g, b(, a)}, ...] in [0, 1] -> [..., 4] (alpha 255
	where not given); "direct_colorcap" like direct, but a colour brighter
	than the range is scaled down as a whole, which keeps its hue. A tensor
	gives a uint8 tensor on its device, anything else a numpy array. driver
	is accepted and ignored; method selects the scalar mode, as in the
	reference."""
	if cmap is not None: desc = cmap
	if method is not None: mode = "scalar"
	a, host = _as_values(arr)
	desc = Colorscheme(desc)
	if len(desc.vals) == 0:
		res = torch.zeros(tuple(a.shape) + (4,), dtype=torch.uint8, device=a.device)
	elif len(desc.vals) == 1:
		res = torch.as_tensor(desc.cols[0], device=a.device).expand(tuple(a.shape) + (4,)).clone()
	elif mode == "scalar":
		res = colorize_scalar_python(a.reshape(-1), desc).reshape(tuple(a.shape) + (4,))
	elif mode == "direct":
		res = colorize_direct_python(a.reshape(a.shape[0], -1), desc).reshape(tuple(a.shape[1:]) + (4,))
	elif mode == "direct_colorcap":
		res = colorize_direct_colorcap(a.reshape(a.shape[0], -1), desc).reshape(tuple(a.shape[1:]) + (4,))
	else:
		raise ValueError("Unknown colorize mode '%s'" % str(mode))
	return res.cpu().numpy() if host else res


def _tables(desc, device):
	"""The scheme's node positions [n] and bytes by channel [4, n], float64
	tensors on device."""
	return (torch.as_tensor(np.asarray(desc.vals, np.float64), device=device),
		torch.as_tensor(np.ascontiguousarray(np.asarray(desc.cols, np.float64).T), device=device))


def _to_bytes(col):
	"""float64 values in [0, 255] (NaN taken as 0, as numpy's cast gives
	it) truncated to uint8."""
	return torch.nan_to_num(col, nan=0.0).to(torch.uint8)


def colorize_scalar_python(a, desc):
	"""Values a [N] -> RGBA [N, 4] uint8 through the scheme
	(pixell_tpu.colorize.colorize_scalar_python :131), on a's device;
	non-finite values fully transparent."""
	a, host = _as_values(a)
	vals, cols = _tables(desc, a.device)
	nv = len(vals)
	def lookup(x):
		x = x.to(torch.float64)
		bad = ~torch.isfinite(x)
		i = torch.searchsorted(vals, x.contiguous()).clamp(1, nv - 1)
		j = i - 1
		lo, hi = vals[j], vals[i]
		t = ((x - lo)/(hi - lo)).clamp(0, 1)
		s = 1 - t
		res = torch.empty((x.shape[0], 4), dtype=torch.uint8, device=x.device)
		# a channel at a time: gathers from one row of the table each, which
		# the card does at its memory rate (a gather of [N, 4] rows it does not)
		for c in range(4):
			res[:, c] = _to_bytes(torch.round(cols[c][j]*s + cols[c][i]*t).clamp(0, 0xff))
		res[bad] = 0
		return res
	res = _chunked(lookup, a)
	return res.cpu().numpy() if host else res


def colorize_direct_python(a, desc):
	"""Channels a [nc, N] in [0, 1] -> RGBA [N, 4] uint8
	(pixell_tpu.colorize.colorize_direct_python :151): each channel times
	256, clipped to [0, 255] and truncated; alpha 255 where nc < 4; fully
	transparent where the first channel is not finite."""
	a, host = _as_values(a)
	nc = a.shape[0]
	def lookup(x):
		x = x.to(torch.float64)
		good = torch.isfinite(x[0])
		res = torch.full((x.shape[1], 4), 255, dtype=torch.uint8, device=x.device)
		res[:, :nc] = _to_bytes((x[:4]*256).clamp(0, 255)).T
		res[~good] = 0
		return res
	res = _chunked(lookup, a)
	return res.cpu().numpy() if host else res


def colorize_direct_colorcap(a, desc):
	"""Direct mode with the colour capped as a whole: where the brightest of
	r, g, b times 256 exceeds 255, all three are scaled down by 255 over it
	(pixell_tpu.colorize.colorize_direct_colorcap :156)."""
	a, host = _as_values(a)
	nc = a.shape[0]
	def lookup(x):
		x = x.to(torch.float64)
		good = torch.isfinite(x[0])
		rgb = x[:min(nc, 3)]*256
		peak = rgb.amax(0)
		num = torch.full_like(peak, 255.0)
		scale = torch.where(peak > 255, num/torch.clamp(peak, min=1e-30), 1.0)
		rgb = (rgb*scale).clamp(0, 255)
		res = torch.full((x.shape[1], 4), 255, dtype=torch.uint8, device=x.device)
		res[:, :rgb.shape[0]] = _to_bytes(rgb).T
		if nc >= 4: res[:, 3] = _to_bytes((x[3]*256).clamp(0, 255))
		res[~good] = 0
		return res
	res = _chunked(lookup, a)
	return res.cpu().numpy() if host else res


# The reference's names for its compiled drivers (pixell_tpu/colorize.py:184-186).
colorize_scalar_fortran = colorize_scalar_python
colorize_direct_fortran = colorize_direct_python
colorize_direct_colorcap_fortran = colorize_direct_colorcap


def to_mpl_colormap(name, data=None):
	"""One of the schemes as a matplotlib colour map."""
	import matplotlib.colors
	cs = Colorscheme(data if data is not None else name)
	return matplotlib.colors.LinearSegmentedColormap.from_list(name,
		[(v, tuple(c/255.0)) for v, c in zip(cs.vals, cs.cols.astype(float))])


def mpl_register(names=None):
	"""The schemes (or those named) registered as matplotlib colour maps."""
	import matplotlib
	if names is None: names = list(schemes.keys())
	if isinstance(names, str): names = [names]
	for name in names:
		try:
			matplotlib.colormaps.register(to_mpl_colormap(name), name=name)
		except Exception:   # already registered
			pass


def mpl_setdefault(name):
	"""One of the schemes as matplotlib's default colour map."""
	import matplotlib.pyplot
	mpl_register(name)
	matplotlib.pyplot.rcParams['image.cmap'] = name
