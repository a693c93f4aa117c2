"""Map plots (counterpart of pixell_tpu/enplot.py).

PIL images of maps with colour ranges, colour bars, coordinate grids,
contours, annotations, stamps and tiling, and PNG / animation writers, in
the reference's option language (keywords or one argument string, e.g.
enplot.plot(m, "-r 300 -c planck -d 2 -g")).

The map stays on its device up to the RGBA bytes: the massaging (slices,
submaps, downgrading, tiling), the colour range, the normalisation, the
mask and the colour lookup (colorize) run in torch there, and only the
ny x nx x 4 uint8 image is copied to the host, for PIL. Host stages, each a
copy of the map to the host: --op / --op2 (the user's expression runs on a
numpy array, as in the reference; its result goes back to the map's
device), contours (marching squares drawn by PIL), the matplotlib driver
(-D mpl) and the stamps' catalogue positions. The colour range sorts the
map's finite values on the device and interpolates the two order
statistics as numpy's quantile does, in float64, so the range is the
reference's exactly; the normalised map is float64 as numpy's promotion
makes it. PIL and matplotlib are imported inside the functions that draw.

Maps given as file names are read onto the device given as the plot
option device (a keyword of plot or get_map), "cuda" by default, as the
port's other entry points.
"""
from __future__ import annotations
import shlex
import numpy as np
import torch
from . import enmap, colorize, cgrid, utils
from .bunch import Bunch


def define_arg_parser():
	"""The option language of pixell_tpu.enplot.define_arg_parser: the same
	flags and defaults."""
	import argparse
	p = argparse.ArgumentParser(add_help=False)
	# output naming
	p.add_argument("-o", "--oname", type=str,
		default="{dir}{pre}{base}{suf}{comp}{layer}.{ext}")
	p.add_argument("--prefix", type=str, default="")
	p.add_argument("--suffix", type=str, default="")
	p.add_argument("--odir", type=str, default=None)
	p.add_argument("--ext", type=str, default="png")
	# color
	p.add_argument("-c", "--color", type=str, default="planck")
	p.add_argument("-r", "--range", type=str, default=None,
		help="symmetric color range; colon-list for per-component ranges")
	p.add_argument("--min", type=str, default=None)
	p.add_argument("--max", type=str, default=None)
	p.add_argument("-q", "--quantile", type=float, default=0.01)
	p.add_argument("--reverse-color", action="store_true")
	p.add_argument("--rgb", action="store_true",
		help="treat a 3-component map as one RGB image")
	p.add_argument("--rgb-mode", type=str, default="direct")
	p.add_argument("--method", type=str, default="auto",
		help="colorization implementation (accepted; one lookup here)")
	# resolution
	p.add_argument("-u", "-s", "--upgrade", "--scale", dest="upgrade",
		type=str, default="1", help="nearest-neighbor upscale: n or ny,nx")
	p.add_argument("-d", "--downgrade", type=str, default="1",
		help="pixel-average downscale: n or ny,nx")
	# map massaging
	p.add_argument("--slice", type=str, default=None,
		help="numpy slice applied before plotting")
	p.add_argument("--sub", type=str, default=None,
		help="dec1:dec2,ra1:ra2 subregion (degrees)")
	p.add_argument("--geometry", type=str, default=None,
		help="plot the part covered by this geometry file")
	p.add_argument("--op", type=str, default=None,
		help="expression in m applied before plotting, e.g. log(abs(m))")
	p.add_argument("--op2", type=str, default=None,
		help="like --op but allows multiple statements")
	p.add_argument("-H", "--hdu", type=int, default=0)
	p.add_argument("--address", type=str, default=None,
		help="hdf group/dataset to read")
	p.add_argument("-m", "--mask", type=float, default=None)
	p.add_argument("--mask-tol", type=float, default=1e-14)
	p.add_argument("-a", "--autocrop", action="store_true")
	p.add_argument("-A", "--autocrop-each", action="store_true")
	p.add_argument("-F", "--fix-wcs", action="store_true")
	p.add_argument("-S", "--symmetric", action="store_true",
		help="plot only the non-redundant triangle of matrix pre-axes")
	p.add_argument("-z", "--zenith", action="store_true",
		help="label the zenith angle instead of the declination")
	p.add_argument("-E", "--nonempty", action="store_true",
		help="skip fully masked components")
	p.add_argument("--pos-ra", action="store_true",
		help="RA labels run 0..360 instead of -180..180")
	p.add_argument("--stamps", type=str, default=None,
		help="srcfile:size:nmax -- plot postage stamps instead of the map")
	p.add_argument("--tile", type=str, default=None,
		help="stack components into rows,cols (-1 = auto)")
	p.add_argument("--tile-transpose", action="store_true")
	p.add_argument("--tile-dims", type=str, default=None)
	# grid
	p.add_argument("-g", "--grid", action="count", default=1,
		help="toggle the coordinate grid")
	p.add_argument("--grid-color", type=str, default="00000020")
	p.add_argument("--grid-width", type=int, default=1)
	p.add_argument("-t", "--ticks", type=str, default="1",
		help="grid spacing in degrees: t or ty,tx")
	p.add_argument("--tick-unit", "--tu", type=str, default=None,
		help="degree/arcmin/arcsec (or d/m/s) or a size in degrees")
	p.add_argument("--nolabels", action="store_true")
	p.add_argument("--nstep", type=int, default=200)
	p.add_argument("--subticks", type=float, default=0,
		help="subtick spacing (mpl driver only)")
	# decorations
	p.add_argument("-b", "--colorbar", action="count", default=0)
	p.add_argument("--font", type=str, default="arial.ttf")
	p.add_argument("--font-size", type=int, default=12)
	p.add_argument("--font-color", type=str, default="000000")
	p.add_argument("-C", "--contours", type=str, default=None,
		help="contour spec: step, base:step, or v1,v2,...")
	p.add_argument("--contour-type", type=str, default="uniform")
	p.add_argument("--contour-color", type=str, default="000000")
	p.add_argument("--contour-width", type=int, default=1)
	p.add_argument("--annotate", type=str, default=None,
		help="annotation file: 'c[ircle]/t[ext]/l[ine]/p[oint] dec ra ...'")
	p.add_argument("--annotate-maxrad", type=int, default=0)
	p.add_argument("-L", "--layers", action="store_true",
		help="return the separate layers instead of compositing")
	p.add_argument("--no-image", action="store_true")
	# driver / misc
	p.add_argument("-D", "--driver", type=str, default="pil")
	p.add_argument("--mpl-dpi", type=float, default=75)
	p.add_argument("--mpl-pad", type=float, default=1.6)
	p.add_argument("-v", dest="verbosity", action="count", default=0)
	p.add_argument("--verbosity", dest="verbosity", type=int)
	# pixell_tpu's own extras
	p.add_argument("--flip", action="store_true")
	p.add_argument("--transpose", action="store_true")
	return p

_parser = None
def parse_args(args="", noglob=False):
	"""A command-line style option string (or list) parsed into a Bunch
	(pixell_tpu.enplot.parse_args)."""
	global _parser
	if _parser is None: _parser = define_arg_parser()
	if isinstance(args, str):
		args = shlex.split(args)
	res, _ = _parser.parse_known_args(args)
	return Bunch(**vars(res))

def _parse_scale(desc):
	"""'n' or 'ny,nx' -> [ny, nx] ints."""
	toks = [int(float(t)) for t in str(desc).split(",")]
	return toks*2 if len(toks) == 1 else toks[:2]

def build_oname(args, base="map", comp="", layer="", fname=None):
	"""Expand the {dir}{pre}{base}{suf}{comp}{layer}.{ext} output format."""
	if fname is not None:
		d, base, iext = split_file_name(fname)
	else:
		d, iext = ".", "png"
	d = args.odir if getattr(args, "odir", None) else d
	if d and not d.endswith("/"): d += "/"
	if d == "./": d = ""
	fmt = getattr(args, "oname", None) or "{dir}{pre}{base}{suf}{comp}{layer}.{ext}"
	if "{" not in fmt:
		return fmt if not comp else "%s%s" % (fmt, comp)
	return fmt.format(dir=d, pre=getattr(args, "prefix", ""), base=base,
		suf=getattr(args, "suffix", ""), comp=comp, layer=layer,
		ext=getattr(args, "ext", "png") or iext)


# ---------------------------------------------------------------------------
# The map's data: on its device, and the host copies of the host stages
# ---------------------------------------------------------------------------
def _data(m):
	"""The tensor behind an ndmap, a tensor itself, or host data as a CPU tensor."""
	if isinstance(m, enmap.ndmap): return m.data
	if isinstance(m, torch.Tensor): return m
	return torch.as_tensor(np.asarray(m))

def _host(m):
	"""A numpy copy of the map's data (a host stage)."""
	d = m.data if isinstance(m, enmap.ndmap) else m
	return d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)

def _np_dtype(t):
	return torch.empty(0, dtype=t.dtype).numpy().dtype

def _device_of(opts):
	return getattr(opts, "device", None) or "cuda"

def _as_map(m, opts):
	return m if isinstance(m, enmap.ndmap) else enmap.enmap(m, device=_device_of(opts))

def _normalize(arr, lo, span):
	"""(arr - lo)/span in numpy's result dtype of arr with lo and span
	(numpy scalars: float64 for a float32 map and a float64 range), on arr's
	device; the division by a tensor on that device, which CUDA does
	exactly (not by a Python number: a product with its reciprocal)."""
	lo, span = np.asarray(lo)[()], np.asarray(span)[()]
	dt = torch.from_numpy(np.zeros(0, np.result_type(_np_dtype(arr), lo.dtype, span.dtype))).dtype
	return (arr.to(dt) - float(lo))/torch.tensor(float(span), dtype=dt, device=arr.device)

def _nanmin(a):
	v = a[~torch.isnan(a)]
	return float(v.min()) if v.numel() else float("nan")

def _nanmax(a):
	v = a[~torch.isnan(a)]
	return float(v.max()) if v.numel() else float("nan")


def _quantiles(vals, qs):
	"""numpy's linear quantiles qs of the 1d tensor vals (finite values):
	its order statistics from one sort on vals' device, interpolated on the
	host by numpy's own arithmetic for its linear method
	(numpy/lib/_function_base_impl.py: the virtual index (n - 1) q,
	_get_indexes, _lerp), so the result is np.quantile's to the bit
	(float64 for a float32 map)."""
	n = vals.numel()
	q = np.asanyarray(qs)
	vi = np.asanyarray((n - 1)*q)
	prev = np.floor(vi)
	nxt = prev + 1
	above, below = vi >= n - 1, vi < 0
	prev[above] = nxt[above] = n - 1
	prev[below] = nxt[below] = 0
	prev, nxt = prev.astype(np.intp), nxt.astype(np.intp)
	srt = torch.sort(vals)[0]
	idx = torch.as_tensor(np.concatenate([prev, nxt]), device=vals.device)
	picked = srt[idx].cpu().numpy()
	a, b = picked[:len(q)], picked[len(q):]
	gamma = np.asanyarray(vi - prev, dtype=vi.dtype)
	diff = np.subtract(b, a)
	res = np.asanyarray(np.add(a, diff*gamma))
	np.subtract(b, diff*(1 - gamma), out=res, where=gamma >= 0.5, casting="unsafe", dtype=type(res.dtype))
	return res


def get_color_range(arr, quantile=0.01, symmetric=True):
	"""The colour range [lo, hi] from the quantile and 1 - quantile of the
	finite values, symmetric about 0 by default (pixell_tpu.enplot.
	get_color_range): float64 numpy, equal to the reference's; the values
	are selected and sorted on the map's device."""
	a = _data(arr)
	good = torch.isfinite(a)
	if not bool(good.any()): return np.array([0.0, 1.0])
	lo, hi = _quantiles(a[good], [quantile, 1-quantile])
	if symmetric:
		m = max(abs(lo), abs(hi))
		if m == 0: m = 1
		return np.array([-m, m])
	if hi == lo: hi = lo + 1
	return np.array([lo, hi])

_TICK_UNITS = {"d": 1.0, "degree": 1.0, "m": 1/60., "arcmin": 1/60.,
	"s": 1/3600., "arcsec": 1/3600.}

def _upgrade_of(args):
	return _parse_scale(getattr(args, "upgrade", 1))

def _color_desc(args):
	desc = colorize.Colorscheme(args.color)
	if getattr(args, "reverse_color", False): desc = desc.reverse()
	return desc

def draw_map_field(map, args, crange=None):
	"""One 2d field (or rgb triple) rendered to a PIL image, and
	Bunch(crange) (pixell_tpu.enplot.draw_map_field). Up to the RGBA bytes
	on the map's device; those are copied to the host for PIL."""
	from PIL import Image
	if args.autocrop:
		map = enmap.autocrop(map)
	dg = _parse_scale(getattr(args, "downgrade", 1))
	if max(dg) > 1:
		map = enmap.downgrade(map, dg)
	arr = _data(map)
	rgb = getattr(args, "rgb", False) and arr.ndim == 3
	if crange is None:
		if args.range is not None:
			r = float(str(args.range).split(":")[0])
			crange = np.array([-r, r])
		elif args.min is not None or args.max is not None:
			crange = np.array([float(args.min if args.min is not None else _nanmin(arr)),
				float(args.max if args.max is not None else _nanmax(arr))])
		else:
			crange = get_color_range(arr, args.quantile)
	norm = _normalize(arr, crange[0], crange[1] - crange[0])
	if args.mask is not None:
		tol = getattr(args, "mask_tol", 1e-14) or 0
		norm = torch.where(torch.abs(arr - args.mask) <= tol, torch.nan, norm)
	if rgb:
		rgba = colorize.colorize(torch.clamp(norm, 0, 1), _color_desc(args),
			mode=getattr(args, "rgb_mode", "direct") or "direct")
	else:
		rgba = colorize.colorize(norm, _color_desc(args))
	if getattr(args, "no_image", False):
		rgba = torch.zeros_like(rgba)
	# maps are stored with y increasing upward (dec); images have y down
	rgba = torch.flip(rgba, [0]).cpu().numpy()
	img = Image.fromarray(np.ascontiguousarray(rgba), "RGBA")
	uy, ux = _upgrade_of(args)
	if max(uy, ux) > 1:
		img = img.resize((img.size[0]*ux, img.size[1]*uy), Image.NEAREST)
	map2d = map if map.ndim == 2 else enmap.samewcs(arr[0], map)
	if args.contours:
		img = draw_contours(img, map2d, args)
	if args.annotate:
		img = draw_annotations(img, map2d, args)
	if args.grid % 2:
		steps = [float(t) for t in str(args.ticks).split(",")]
		if len(steps) == 1: steps = steps*2
		unit = 1.0
		tu = getattr(args, "tick_unit", None)
		if tu: unit = _TICK_UNITS.get(str(tu), None) or float(tu)
		gi = cgrid.calc_gridinfo(map.shape, map.wcs, steps=steps,
			nstep=[getattr(args, "nstep", 200) or 200]*2,
			zenith=getattr(args, "zenith", False), unit=unit)
		if getattr(args, "pos_ra", False):
			gi.lon = [(val % 360, seg) for val, seg in gi.lon]
		# flip y for image coords
		ny = map.shape[-2]
		for group in [gi.lat, gi.lon]:
			for k in range(len(group)):
				val, seg = group[k]
				seg = seg.copy()
				seg[:, 1] = ny - 1 - seg[:, 1]
				seg = seg*[ux, uy]
				group[k] = (val, seg)
		cgrid.draw_grid(img, gi, color=getattr(args, "grid_color", "00000020"),
			width=getattr(args, "grid_width", 1) or 1)
		if not args.nolabels:
			labels = cgrid.calc_label_pos(gi, (ny*uy, map.shape[-1]*ux))
			fcol = getattr(args, "font_color", "000000") or "000000"
			if len(fcol) == 6: fcol += "ff"
			cgrid.draw_labels(img, labels, color=fcol,
				fsize=getattr(args, "font_size", 12) or 12)
	return img, Bunch(crange=crange)

def draw_colorbar(crange, width, args):
	"""A 16-pixel colour bar of the given width with the range's ends
	written on it (pixell_tpu.enplot.draw_colorbar); host numpy."""
	from PIL import Image, ImageDraw
	bar = np.linspace(0, 1, max(width, 2))[None].repeat(16, 0)
	rgba = colorize.colorize(bar, args.color)
	img = Image.fromarray(rgba, "RGBA")
	draw = ImageDraw.Draw(img)
	draw.text((2, 2), "%.3g" % crange[0], fill=(0, 0, 0, 255))
	txt = "%.3g" % crange[1]
	draw.text((width - 8*len(txt), 2), txt, fill=(0, 0, 0, 255))
	return img

def _op_result(res, m):
	"""The result of a host expression back on the map's device, with its wcs."""
	return enmap.ndmap(torch.as_tensor(np.asarray(res), device=_data(m).device), m.wcs)

def _massage_map(m, opts, fname=None):
	"""The pre-plot map options (hdu / address act when reading): fix-wcs,
	slice, sub, geometry, op / op2 (host stages), stamps, tile, symmetric."""
	if getattr(opts, "fix_wcs", False):
		m = enmap.ndmap(_data(m), cgrid.fix_wcs(m.wcs))
	if getattr(opts, "slice", None):
		m = eval("m[" + opts.slice + "]", {"m": m, "np": np})
	if getattr(opts, "sub", None):
		decs, ras = opts.sub.split(",")
		d1, d2 = [float(v) for v in decs.split(":")]
		r1, r2 = [float(v) for v in ras.split(":")]
		box = np.array([[d1, r1], [d2, r2]])*utils.degree
		m = m.submap(box)
	if getattr(opts, "geometry", None):
		gshape, gwcs = enmap.read_map_geometry(opts.geometry)
		m = m.submap(np.asarray(enmap.corners(gshape, gwcs)))
	if getattr(opts, "op", None):
		m = _op_result(eval(opts.op, {"m": _host(m), "np": np}, np.__dict__), m)
	if getattr(opts, "op2", None):
		loc = {"m": _host(m), "np": np}
		exec(opts.op2, np.__dict__, loc)
		m = _op_result(loc["m"], m)
	if getattr(opts, "stamps", None):
		m = enmap.samewcs(extract_stamps(m, opts), m)
	if getattr(opts, "symmetric", False) and m.ndim >= 4:
		rows, cols = m.shape[0], m.shape[1]
		d = _data(m)
		m = enmap.samewcs(torch.stack([d[i, j] for i in range(rows) for j in range(cols) if j <= i]), m)
	if getattr(opts, "tile", None) is not None and m.ndim > 2:
		spec = [int(v) for v in str(opts.tile).split(",")]
		nrow = spec[0]
		ncol = spec[1] if len(spec) > 1 else -1
		exp = hwexpand(_data(m), nrow=nrow, ncol=ncol,
			transpose=getattr(opts, "tile_transpose", False))
		m = enmap.samewcs(hwstack(exp), m)
	return m


def plot(imap, args="", comm=None, noglob=False, **kwargs):
	"""Plot a map (or a list of them): a list of Bunch(name, img, type,
	info) (pixell_tpu.enplot.plot). A file name is read (honouring --hdu /
	--address) onto the device given as the option device (default
	"cuda"); see define_arg_parser for the options."""
	opts = parse_args(args)
	for k, v in kwargs.items():
		opts[k.replace("-", "_")] = v
	maps = imap if isinstance(imap, (list, tuple)) else [imap]
	plots = []
	for mi, m in enumerate(maps):
		fname = m if isinstance(m, str) else None
		if fname is not None:
			m = enmap.read_map(fname, hdu=getattr(opts, "hdu", 0) or None,
				address=getattr(opts, "address", None), device=_device_of(opts))
		m = _as_map(m, opts)
		m = _massage_map(m, opts, fname=fname)
		rgb = getattr(opts, "rgb", False) and m.ndim > 2 and m.shape[0] >= 3
		if rgb:
			fields, n = [m], 1
		else:
			fields = m.preflat() if m.ndim > 2 else [m]
			n = len(fields) if m.ndim > 2 else 1
		rngs = parse_range(opts.range, n) if opts.range and ":" in str(opts.range) else None
		for fi in range(n):
			field = fields[fi] if m.ndim > 2 else m
			if getattr(opts, "nonempty", False):
				a = _data(field)
				masked = ~torch.isfinite(a)
				if opts.mask is not None:
					masked |= torch.abs(a - opts.mask) <= (opts.mask_tol or 0)
				if bool(masked.all()): continue
			if getattr(opts, "autocrop_each", False):
				field = enmap.autocrop(field)
			crange = None
			if rngs is not None:
				crange = np.array([-rngs[fi], rngs[fi]])
			if str(getattr(opts, "driver", "pil")).startswith("mpl"):
				img = draw_map_field_mpl(field, opts, crange=crange)
				info = Bunch(crange=crange if crange is not None
					else get_color_range(field, opts.quantile))
				comp = "" if n == 1 else "_%d" % fi
				plots.append(Bunch(name=build_oname(opts, comp=comp,
					fname=fname), img=img, type="pil", info=info))
				continue
			if getattr(opts, "layers", False):
				# separate map / grid / label layers (-L)
				sub = Bunch(**{k: opts[k] for k in opts})
				sub.grid = 0
				mimg, info = draw_map_field(field, sub, crange=crange)
				comp = "" if n == 1 else "_%d" % fi
				plots.append(Bunch(name=build_oname(opts, comp=comp,
					layer="_map", fname=fname), img=mimg, type="pil", info=info))
				if opts.grid % 2:
					gi = calc_gridinfo(field.shape, field.wcs, opts)
					gimg, _ = draw_grid(gi, opts)
					plots.append(Bunch(name=build_oname(opts, comp=comp,
						layer="_grid", fname=fname), img=gimg, type="pil",
						info=info))
					if not opts.nolabels:
						limg, _ = draw_grid_labels(gi, opts)
						plots.append(Bunch(name=build_oname(opts, comp=comp,
							layer="_labels", fname=fname), img=limg,
							type="pil", info=info))
				continue
			img, info = draw_map_field(field, opts, crange=crange)
			if opts.colorbar:
				from PIL import Image
				bar = draw_colorbar(info.crange, img.size[0], opts)
				tot = Image.new("RGBA", (img.size[0], img.size[1] + bar.size[1]))
				tot.paste(img, (0, 0)); tot.paste(bar, (0, img.size[1]))
				img = tot
			comp = "" if n == 1 else "_%d" % fi
			name = build_oname(opts, comp=comp, fname=fname)
			plots.append(Bunch(name=name, img=img, type="pil", info=info))
	return plots

def write(fname, plots):
	"""The plots written to image file(s): fname for one, fname_i.ext for
	several (pixell_tpu.enplot.write)."""
	plots = plots if isinstance(plots, (list, tuple)) else [plots]
	if len(plots) == 1:
		plots[0].img.save(fname)
		return [fname]
	names = []
	for i, p in enumerate(plots):
		base, _, ext = fname.rpartition(".")
		n = "%s_%d.%s" % (base or fname, i, ext or "png")
		p.img.save(n)
		names.append(n)
	return names

def pshow(imap, args="", **kwargs):
	"""Plot and show inline (IPython) or in PIL's viewer."""
	plots = plot(imap, args, **kwargs)
	for p in plots:
		try:
			from IPython.display import display
			display(p.img)
		except ImportError:
			p.img.show()
	return plots

def pwrite(fname, imap, args="", **kwargs):
	return write(fname, plot(imap, args, **kwargs))

def plot_iterator(*maps, comm=None, **kwargs):
	"""The plots of maps, strided over the communicator's ranks."""
	rank = getattr(comm, "rank", 0)
	size = getattr(comm, "size", 1)
	for i, m in enumerate(maps):
		if i % size != rank: continue
		for p in plot(m, **kwargs):
			yield p

class Writer:
	"""A sink of plots: process() takes them one at a time, close()
	finishes; a context manager."""
	def __init__(self, fname=None, **kwargs):
		self.fname = fname
	def process(self, plot, prefix=""):
		raise NotImplementedError
	def write(self, plots): return write(self.fname, plots)
	def close(self): pass
	def __enter__(self): return self
	def __exit__(self, type, value, traceback): self.close()

class PlotWriter(Writer):
	"""Writes image plots to files and hands video plots to a VideoWriter."""
	def __init__(self, fname=None, **kwargs):
		super().__init__(fname)
		self.vid_writer = VideoWriter(**kwargs)
	def process(self, plot, prefix=""):
		ptype = getattr(plot, "type", "pil")
		if ptype == "vid":
			self.vid_writer.process(plot, prefix=prefix)
		elif ptype == "pil":
			plot.img.save(prefix + plot.name)
		elif ptype == "mpl":
			plot.img.savefig(prefix + plot.name, bbox_inches="tight",
				dpi=getattr(plot, "dpi", 100))
		else:
			raise ValueError("Unknown plot type '%s'" % str(ptype))
	def close(self):
		self.vid_writer.close()

class VideoWriter(Writer):
	"""Collects frames into an animated file written by PIL (gif / webp),
	as pixell_tpu.enplot.VideoWriter does."""
	def __init__(self, fname=None, fps=10, **kwargs):
		super().__init__(fname)
		self.frames = []
		self.fps = fps
	def new(self, fname, img=None):
		"""Finish the current animation and start another."""
		self.close()
		self.fname = fname
	def process(self, plot, prefix=""):
		fname = prefix + getattr(plot, "name", self.fname or "video.gif")
		if self.fname is not None and fname != self.fname:
			self.new(fname)
		elif self.fname is None:
			self.fname = fname
		self.add(plot)
	def add(self, plots):
		p = plots[0] if isinstance(plots, (list, tuple)) else plots
		self.frames.append(p.img.convert("RGB"))
	def finish(self):
		if not self.frames: return
		self.frames[0].save(self.fname, save_all=True,
			append_images=self.frames[1:], duration=int(1000/self.fps), loop=0)
		self.frames = []
	def close(self):
		if self.frames and self.fname:
			self.finish()


def _contour_levels(spec, arr, ctype="uniform"):
	"""Contour levels from the -C syntax: "step", "base:step" or
	"v1,v2,..."; a list follows --contour-type: uniform ([interval] or
	[base, interval]) or list (the values); host numpy."""
	if not isinstance(spec, str):
		vals = np.atleast_1d(np.asarray(spec, float))
		if ctype == "list" or len(vals) > 2:
			return vals
		base = vals[0] if len(vals) == 2 else 0.0
		step = vals[-1]
	else:
		toks = str(spec).split(",")
		if len(toks) > 1:
			return np.array([float(t) for t in toks])
		sub = toks[0].split(":")
		base = float(sub[0]) if len(sub) == 2 else 0.0
		step = float(sub[-1])
	lo = base + np.floor((np.nanmin(arr) - base)/step)*step
	hi = np.nanmax(arr)
	return np.arange(lo, hi + step, step)

def draw_contours(img, map, args):
	"""Iso-level contours by marching squares, drawn onto img (a host stage:
	the map is copied to the host for the cell loop and PIL)."""
	from PIL import ImageDraw
	arr = _host(map)
	levels = _contour_levels(args.contours, arr,
		ctype=getattr(args, "contour_type", "uniform"))
	cdesc = str(getattr(args, "contour_color", "000000"))
	if len(cdesc) == 6: cdesc += "ff"
	col = tuple(int(cdesc[i:i+2], 16) for i in range(0, 8, 2))
	width = int(getattr(args, "contour_width", 1) or 1)
	draw = ImageDraw.Draw(img, "RGBA")
	ny, nx = arr.shape[-2:]
	u = _upgrade_of(args)[1]
	for lev in levels:
		# for each cell, the crossings interpolated along its edges
		a = arr[:-1, :-1]; b = arr[:-1, 1:]; c = arr[1:, :-1]; d = arr[1:, 1:]
		above = (np.stack([a, b, c, d]) > lev)
		cells = np.where(above.any(0) & ~above.all(0))
		for cy, cx in zip(*cells[-2:] if len(cells) > 2 else cells):
			pts = []
			vals = [arr[cy, cx], arr[cy, cx+1], arr[cy+1, cx], arr[cy+1, cx+1]]
			# edges: top (0-1), left (0-2), right (1-3), bottom (2-3)
			edges = [((cx, cy), (cx+1, cy), vals[0], vals[1]),
				((cx, cy), (cx, cy+1), vals[0], vals[2]),
				((cx+1, cy), (cx+1, cy+1), vals[1], vals[3]),
				((cx, cy+1), (cx+1, cy+1), vals[2], vals[3])]
			for (x1, y1), (x2, y2), v1, v2 in edges:
				if (v1 > lev) != (v2 > lev) and v2 != v1:
					t = (lev - v1)/(v2 - v1)
					pts.append((x1 + t*(x2-x1), y1 + t*(y2-y1)))
			if len(pts) >= 2:
				# the image's y axis runs down
				p = [((x)*u, (ny-1-yv)*u) for x, yv in pts[:2]]
				draw.line(p, fill=col, width=width)
	return img

def draw_annotations(img, map, args):
	"""Circles, points, text and lines from an annotation file or list,
	drawn onto img: "c/p/t dec ra dy dx ..." or "l dec1 ra1 dy1 dx1 dec2
	ra2 dy2 dx2 [width [colour]]", and the short "c dec ra rad" / "t dec ra
	text" forms (pixell_tpu.enplot.draw_annotations)."""
	from PIL import ImageDraw
	draw = ImageDraw.Draw(img, "RGBA")
	ny = map.shape[-2]
	u = _upgrade_of(args)[1]
	maxrad = int(getattr(args, "annotate_maxrad", 0) or 0)
	entries = args.annotate
	if isinstance(entries, str):
		with open(entries) as f:
			entries = [line.split() for line in f if line.strip()]
	def topix(lat, lon, dy, dx):
		pix = np.asarray(enmap.sky2pix(map.shape, map.wcs,
			np.array([[float(lat)*utils.degree], [float(lon)*utils.degree]])))[:, 0]
		return (pix[1] + float(dx))*u, (ny - 1 - (pix[0] + float(dy)))*u
	def color_of(tok, default=(0, 0, 0, 255)):
		if tok is None: return default
		s = str(tok)
		named = {"black": "000000", "white": "ffffff", "red": "ff0000",
			"green": "00ff00", "blue": "0000ff"}
		s = named.get(s.lower(), s)
		if len(s) == 6: s += "ff"
		try: return tuple(int(s[i:i+2], 16) for i in range(0, 8, 2))
		except ValueError: return default
	for e in entries:
		kind = str(e[0]).lower()
		longform = len(e) >= 5 and all(_isnum(v) for v in e[3:5]) or \
			(kind[0] == "l")
		if kind[0] in "cp":
			if longform:
				x, y = topix(e[1], e[2], e[3], e[4])
				r = float(e[5]) if len(e) > 5 else 10
				w = int(float(e[6])) if len(e) > 6 else 1
				col = color_of(e[7] if len(e) > 7 else None)
			else:
				x, y = topix(e[1], e[2], 0, 0)
				r = float(e[3]) if len(e) > 3 else 10
				w, col = 1, (255, 0, 0, 255)
			if maxrad and not (-maxrad <= x < img.size[0] + maxrad and
					-maxrad <= y < img.size[1] + maxrad):
				continue
			if kind[0] == "p":
				draw.ellipse([x-2, y-2, x+2, y+2], fill=col)
			else:
				draw.ellipse([x-r, y-r, x+r, y+r], outline=col, width=w)
		elif kind[0] == "t":
			if longform:
				x, y = topix(e[1], e[2], e[3], e[4])
				txt = e[5] if len(e) > 5 else ""
				col = color_of(e[7] if len(e) > 7 else None)
			else:
				x, y = topix(e[1], e[2], 0, 0)
				txt = " ".join(e[3:])
				col = (0, 0, 0, 255)
			if maxrad and not (-maxrad <= x < img.size[0] + maxrad and
					-maxrad <= y < img.size[1] + maxrad):
				continue
			draw.text((x, y), txt, fill=col)
		elif kind[0] == "l":
			x1, y1 = topix(e[1], e[2], e[3], e[4])
			x2, y2 = topix(e[5], e[6], e[7], e[8])
			w = int(float(e[9])) if len(e) > 9 else 1
			col = color_of(e[10] if len(e) > 10 else None)
			draw.line([(x1, y1), (x2, y2)], fill=col, width=w)
	return img

def _isnum(v):
	try:
		float(v)
		return True
	except (TypeError, ValueError):
		return False


# ---------------------------------------------------------------------------
# The rest of the reference's public names (pixell_tpu/enplot.py:585-947)
# ---------------------------------------------------------------------------
class BackendError(Exception): pass

class Printer:
	"""A printer by level (pixell_tpu.enplot.Printer)."""
	def __init__(self, level=1, prefix=""):
		self.level = level
		self.prefix = prefix
	def write(self, desc, level=1, exact=None, newline=True, prepend=""):
		if level <= self.level or level == exact:
			import sys
			sys.stderr.write(prepend + self.prefix + desc + ("\n" if newline else ""))
	def push(self, desc):
		return Printer(self.level, self.prefix + desc)
	def time(self, desc, level=1, exact=None):
		class _T:
			def __enter__(s): return s
			def __exit__(s, *a): pass
		return _T()

noprint = Printer(level=0)

def get_plots(*arglist, **args):
	"""plot under its other name."""
	return plot(*arglist, **args)

def extract_arg(args, name, default):
	if name in args: return args.pop(name)
	return default

def check_args(kwargs):
	parser = define_arg_parser()
	known = set()
	for action in parser._actions:
		known.add(action.dest)
	bad = [k for k in kwargs if k not in known]
	if bad: raise ValueError("Unrecognized plot arguments: %s" % str(bad))

def get_cache(cache, key, fun):
	if cache is None: return fun()
	if key not in cache: cache[key] = fun()
	return cache[key]

def get_map(ifile, args, return_info=False, name=None):
	"""A map read (a file name, onto the device given as args.device, "cuda"
	by default) or taken as given, with the plot options applied: slice,
	sub, geometry, op / op2, stamps, tile, symmetric, then downgrade and
	autocrop (pixell_tpu.enplot.get_map)."""
	if isinstance(ifile, str):
		m = enmap.read_map(ifile, hdu=getattr(args, "hdu", 0) or None,
			address=getattr(args, "address", None), device=_device_of(args))
	else:
		m = _as_map(ifile, args)
	m = _massage_map(m, args, fname=ifile if isinstance(ifile, str) else None)
	dg = _parse_scale(getattr(args, "downgrade", 1) or 1)
	if max(dg) > 1:
		m = enmap.downgrade(m, dg)
	if getattr(args, "autocrop", False):
		m = enmap.autocrop(m)
	if return_info:
		return m, Bunch(fname=ifile if isinstance(ifile, str) else (name or "map"),
			ishape=m.shape, names=[])
	return m

def parse_range(desc, n):
	if desc is None: return None
	parts = str(desc).split(":")
	res = np.array([float(p) for p in parts])
	return np.concatenate([res, np.repeat(res[-1:], n - len(res))])[:n]

def parse_list(desc, dtype=float, sep=","):
	if desc is None or desc == "": return []
	return [dtype(tok) for tok in str(desc).split(sep)]

def get_num_digits(n):
	return int(np.log10(max(n, 1))) + 1

def split_file_name(fname):
	"""fname -> (directory, base name, extension)."""
	import os
	dirname, base = os.path.split(fname)
	if not dirname: dirname = "."
	base, ext = os.path.splitext(base)
	return dirname, base, ext.lstrip(".")

def is_video_ext(ext):
	return ext.lower() in ["gif", "mp4", "webm", "avi", "mov"]

def map_to_color(map, crange, args):
	"""The colour image [{r, g, b, a}, ny, nx] uint8 of the map's first
	field in the range crange, on the map's device (pixell_tpu.enplot.
	map_to_color; args is the options or a scheme's name)."""
	arr = _data(map)
	if arr.ndim > 2: arr = arr.reshape((-1,) + tuple(arr.shape[-2:]))[0]
	x = _normalize(arr, crange[0], max(crange[1] - crange[0], 1e-300))
	cmap = getattr(args, "color", "planck") if not isinstance(args, str) else args
	rgba = colorize.colorize(x, cmap if isinstance(cmap, str) else "planck")
	return torch.movedim(rgba, -1, 0)

def calc_contours(crange, args):
	"""The contour levels of the spec in args over a value range."""
	spec = getattr(args, "contours", None)
	if spec is None: return None
	return _contour_levels(spec, np.asarray(crange))

def parse_annotations(afile):
	"""An annotation file as [[type, args...]] entries."""
	res = []
	with open(afile, "r") as f:
		for line in f:
			line = line.strip()
			if not line or line.startswith("#"): continue
			res.append(line.split())
	return res

def calc_gridinfo(shape, wcs, args):
	"""The grid lines' points for a map of the given geometry."""
	tickspec = [float(t) for t in str(getattr(args, "ticks", 1) or 1).split(",")]
	ticks = np.zeros(2) + (tickspec*2 if len(tickspec) == 1 else tickspec[:2])
	nstep = np.zeros(2, int) + (getattr(args, "nstep", 200) or 200)
	ginfo = cgrid.calc_gridinfo(shape, wcs, steps=ticks, nstep=nstep,
		zenith=getattr(args, "zenith", False))
	ginfo.shape = tuple(shape[-2:])
	return ginfo

def draw_grid(ginfo, args):
	"""(img, bounds): the grid lines on a transparent canvas."""
	from PIL import Image
	size = tuple(int(v) for v in np.asarray(ginfo.shape[-2:])[::-1])
	img = Image.new("RGBA", size)
	img = cgrid.draw_grid(img, ginfo, color=getattr(args, "grid_color", None) or "00000020")
	bounds = np.array([[0, 0], list(img.size)])
	return img, bounds

def draw_grid_labels(ginfo, args):
	"""(img, bounds): the grid labels on a transparent canvas."""
	from PIL import Image
	size = tuple(int(v) for v in np.asarray(ginfo.shape[-2:])[::-1])
	img = Image.new("RGBA", size)
	labels = cgrid.calc_label_pos(ginfo, ginfo.shape[-2:])
	img = cgrid.draw_labels(img, labels, fsize=getattr(args, "font_size", 16))
	bounds = np.array([[0, 0], list(img.size)])
	return img, bounds

def standardize_images(tuples):
	"""(img, bounds) layers pasted onto one common canvas each."""
	from PIL import Image
	boxes = np.array([np.asarray(b) for i, b in tuples if b is not None])
	if len(boxes) == 0:
		return [i for i, b in tuples]
	lo = boxes[:, 0].min(0)
	hi = boxes[:, 1].max(0)
	size = tuple((hi - lo).astype(int))
	out = []
	for img, b in tuples:
		canvas = Image.new("RGBA", size)
		off = tuple((np.asarray(b)[0] - lo).astype(int)) if b is not None else (0, 0)
		canvas.paste(img, off)
		out.append(canvas)
	return out

def merge_images(images):
	"""Same-sized images alpha-composited in order."""
	from PIL import Image
	out = images[0].convert("RGBA")
	for img in images[1:]:
		out = Image.alpha_composite(out, img.convert("RGBA"))
	return out

def merge_plots(plots):
	imgs = [p.img for p in plots]
	return Bunch(img=merge_images(imgs), name=plots[0].name if plots else "")

def prepare_map_field(map, args, crange=None, printer=noprint):
	"""(map, crange): the colour range of one field, from the options'
	quantile unless given."""
	if crange is None:
		crange = get_color_range(map,
			quantile=getattr(args, "quantile", 0.01) or 0.01)
	return map, crange

def makefoot(n):
	"""A circular footprint of radius n, int32."""
	y, x = np.mgrid[-n:n+1, -n:n+1]
	return ((y**2 + x**2) <= n**2).astype(np.int32)

def contour_widen(cmap, width):
	"""Contour lines widened by a grey dilation (host scipy)."""
	from scipy import ndimage
	if width <= 1: return cmap
	return ndimage.grey_dilation(cmap, footprint=makefoot(int(width)))

def draw_ellipse(image, bounds, width=1, outline="white", antialias=1):
	"""An antialiased ellipse outline drawn onto a copy of image."""
	from PIL import Image, ImageDraw
	mask = Image.new("L", (int(image.size[0]*antialias), int(image.size[1]*antialias)), 0)
	draw = ImageDraw.Draw(mask)
	for off, fill in [(width/-2.0, "white"), (width/2.0, "black")]:
		left, top = [(v + off)*antialias for v in bounds[:2]]
		right, bottom = [(v - off)*antialias for v in bounds[2:]]
		draw.ellipse([left, top, right, bottom], fill=fill)
	mask = mask.resize(image.size, Image.LANCZOS)
	result = image.copy()
	result.paste(outline, mask=mask)
	return result

def hwexpand(m, nrow=-1, ncol=-1, transpose=False, dims=None):
	"""Maps [n, ny, nx] placed on a [nrow, ncol, ny, nx] grid, zeros where
	none falls; a tensor on its device, else numpy."""
	if isinstance(m, enmap.ndmap): m = m.data
	t = isinstance(m, torch.Tensor)
	if not t: m = np.asarray(m)
	m = m.reshape((-1,) + tuple(m.shape[-2:]))
	n = m.shape[0]
	if nrow < 0 and ncol < 0: ncol = int(np.ceil(n**0.5))
	if nrow < 0: nrow = (n + ncol - 1)//ncol
	if ncol < 0: ncol = (n + nrow - 1)//nrow
	shape = (nrow, ncol) + tuple(m.shape[-2:])
	out = torch.zeros(shape, dtype=m.dtype, device=m.device) if t else np.zeros(shape, m.dtype)
	for i in range(n):
		r, c = (i//ncol, i % ncol) if not transpose else (i % nrow, i//nrow)
		out[r, c] = m[i]
	return out

def hwstack(mexp):
	"""[nrow, ncol, ny, nx] -> [nrow*ny, ncol*nx]; a tensor on its device,
	else numpy."""
	if not isinstance(mexp, torch.Tensor): mexp = np.asarray(mexp)
	nrow, ncol, ny, nx = mexp.shape[-4:]
	out = torch.movedim(mexp, -3, -2) if isinstance(mexp, torch.Tensor) else np.moveaxis(mexp, -3, -2)
	return out.reshape(tuple(mexp.shape[:-4]) + (nrow*ny, ncol*nx))

def extract_stamps(map, args):
	"""The stack of postage stamps of args.stamps ("srcfile:size:nmax"),
	cut on the map's device at the catalogue's pixels (rounded on the host)."""
	spec = getattr(args, "stamps", None)
	if spec is None: return map
	toks = str(spec).split(":")
	srcfile = toks[0]
	size = int(toks[1]) if len(toks) > 1 else 16
	srcs = np.loadtxt(srcfile, ndmin=2).T
	pixs = np.round(np.asarray(enmap.sky2pix(map.shape, map.wcs,
		srcs[:2]*np.pi/180))).astype(int)
	d = _data(map)
	return torch.stack([d[..., py-size//2:py+size//2, px-size//2:px+size//2] for py, px in pixs.T])

def draw_map_field_mpl(map, args, crange=None, printer=noprint):
	"""The matplotlib driver (-D mpl): imshow of the first field, with a
	colour bar under -b, saved as PNG and opened by PIL (a host stage)."""
	import matplotlib
	matplotlib.use("Agg")
	import matplotlib.pyplot as plt
	import io
	from PIL import Image
	arr = _host(map)
	if arr.ndim > 2: arr = arr.reshape((-1,) + arr.shape[-2:])[0]
	if crange is None: crange = get_color_range(arr)
	fig, ax = plt.subplots()
	im = ax.imshow(arr, vmin=crange[0], vmax=crange[1], origin="lower")
	if getattr(args, "colorbar", 0):
		fig.colorbar(im, pad=0.01*getattr(args, "mpl_pad", 1.6))
	sub = getattr(args, "subticks", 0)
	if sub:
		from matplotlib.ticker import MultipleLocator
		ax.xaxis.set_minor_locator(MultipleLocator(sub))
		ax.yaxis.set_minor_locator(MultipleLocator(sub))
	buf = io.BytesIO()
	fig.savefig(buf, format="png", dpi=getattr(args, "mpl_dpi", 75) or 75)
	plt.close(fig)
	buf.seek(0)
	return Image.open(buf)

def show(img, title=None, method="auto"):
	"""Show an image with the first display backend that works."""
	methods = {"ipython": show_ipython, "tk": show_tk, "wx": show_wx,
		"qt": show_qt}
	if method != "auto":
		return methods[method](img, title=title)
	for m in ["ipython", "tk", "qt", "wx"]:
		try:
			return methods[m](img, title=title)
		except BackendError:
			continue
		except Exception:
			continue
	raise BackendError("Could not find any working display backends")

def show_ipython(img, title=None):
	try:
		from IPython.display import display
	except ImportError:
		raise BackendError("ipython backend unavailable")
	try:
		get_ipython
	except NameError:
		raise BackendError("not in an ipython session")
	plots = img if isinstance(img, list) else [img]
	for p in plots:
		display(getattr(p, "img", p))

def show_tk(img, title=None):
	try:
		import tkinter
		from PIL import ImageTk
	except ImportError:
		raise BackendError("tk backend unavailable")
	plots = img if isinstance(img, list) else [img]
	root = tkinter.Tk()
	if title: root.title(str(title))
	im = getattr(plots[0], "img", plots[0])
	photo = ImageTk.PhotoImage(im)
	label = tkinter.Label(root, image=photo)
	label.pack()
	root.mainloop()

def show_wx(img, title=None):
	raise BackendError("wx backend not available")

def show_qt(img, title=None):
	raise BackendError("qt backend not available")
