"""Coordinate grids and their labels for map plots (counterpart of
pixell_tpu/cgrid.py). The grid's geometry is host numpy (a few hundred
points a line, from the map's wcs); the drawing is PIL's, imported inside
the functions that draw, so that the module imports without PIL."""
from __future__ import annotations
import numpy as np
from . import enmap, utils
from .bunch import Bunch


def calc_gridinfo(shape, wcs, steps=[2, 2], nstep=[200, 200], zenith=False, unit=1):
	"""Compute the pixel paths of meridians and parallels crossing the map
	(pixell_tpu.cgrid.calc_gridinfo). steps in degrees. Returns a Bunch with
	lists .lon and .lat of (value_deg, segments) where segments are [n,2]
	pixel coordinate ((x,y)) arrays."""
	steps = np.zeros(2) + steps
	box = np.sort(np.asarray(enmap.corners(shape, wcs)), 0)/utils.degree
	dec1, dec2 = box[0, 0], box[1, 0]
	ra1, ra2 = box[0, 1], box[1, 1]
	# widen a bit to be safe
	res = Bunch(lon=[], lat=[])
	lat_vals = np.arange(np.ceil(dec1/steps[0])*steps[0], dec2 + 1e-9, steps[0])
	lon_vals = np.arange(np.ceil(ra1/steps[1])*steps[1], ra2 + 1e-9, steps[1])
	for lat in lat_vals:
		ras = np.linspace(ra1, ra2, int(nstep[1]))
		pix = np.asarray(enmap.sky2pix(shape, wcs,
			np.array([ras*0 + lat, ras])*utils.degree, safe=True))
		res.lat.append((lat, np.stack([pix[1], pix[0]], -1)))
	for lon in lon_vals:
		decs = np.linspace(dec1, dec2, int(nstep[0]))
		pix = np.asarray(enmap.sky2pix(shape, wcs,
			np.array([decs, decs*0 + lon])*utils.degree, safe=True))
		res.lon.append((lon % 360, np.stack([pix[1], pix[0]], -1)))
	return res

def draw_grid(img, gridinfo, color="00000020", width=1):
	"""Draw grid lines onto a PIL image (pixell_tpu.cgrid.draw_grid)."""
	from PIL import ImageDraw
	col = tuple(int(color[i:i+2], 16) for i in range(0, 8, 2)) if isinstance(color, str) else color
	draw = ImageDraw.Draw(img, "RGBA")
	W, H = img.size
	for group in [gridinfo.lat, gridinfo.lon]:
		for val, seg in group:
			pts = [(float(x), float(y)) for x, y in seg
				if -10*W <= x <= 11*W and -10*H <= y <= 11*H]
			if len(pts) >= 2:
				draw.line(pts, fill=col, width=width)
	return img

def calc_label_pos(gridinfo, shape):
	"""Positions where grid lines cross the map edges, for labeling
	(pixell_tpu.cgrid.calc_label_pos)."""
	ny, nx = shape[-2:]
	labels = []
	for name, group, fmt in [("lat", gridinfo.lat, "%g"), ("lon", gridinfo.lon, "%g")]:
		for val, seg in group:
			# find the first segment point inside the map near an edge
			inside = (seg[:, 0] >= 0) & (seg[:, 0] < nx) & (seg[:, 1] >= 0) & (seg[:, 1] < ny)
			if not np.any(inside): continue
			i = np.argmax(inside)
			labels.append(Bunch(name=name, val=val, pos=seg[i], text=fmt % val))
	return labels

def draw_labels(img, labels, color="000000ff", fsize=12):
	from PIL import ImageDraw
	col = tuple(int(color[i:i+2], 16) for i in range(0, 8, 2)) if isinstance(color, str) else color
	draw = ImageDraw.Draw(img, "RGBA")
	for lab in labels:
		draw.text((float(lab.pos[0]) + 2, float(lab.pos[1]) + 2), lab.text, fill=col)
	return img


class Gridinfo:
	"""(pixell_tpu.cgrid.Gridinfo)."""
	pass

def fix_wcs(wcs):
	"""A wcs to draw grid lines with (pixell_tpu.cgrid.fix_wcs): the
	identity, as the analytic wcs checks no bounds."""
	return wcs

def calc_bounds(boxes, size):
	"""Bounding box of boxes [:,{from,to},{x,y}], at least ((0,0),size)
	(pixell_tpu.cgrid.calc_bounds)."""
	boxes = np.asarray(boxes)
	return np.array([np.minimum((0, 0), np.min(boxes[:, 0], 0)),
		np.maximum(size, np.max(boxes[:, 1], 0))]).astype(int)

def expand_image(img, bounds):
	from PIL import Image
	res = Image.new("RGBA", tuple(int(v) for v in (bounds[1] - bounds[0])))
	res.paste(img, tuple(int(v) for v in -bounds[0]))
	return res

def get_font(fsize=16, fname="arial.ttf"):
	from PIL import ImageFont
	try:
		return ImageFont.truetype(fname, size=fsize)
	except (IOError, OSError):
		try:
			return ImageFont.truetype("DejaVuSans.ttf", size=fsize)
		except (IOError, OSError):
			return ImageFont.load_default()

def calc_line_segs(pixs, steplim=10.0, extrapolate=2.0):
	"""Split a point sequence at huge jumps, extrapolating the cut edges
	(pixell_tpu.cgrid.calc_line_segs)."""
	pixs = np.asarray(pixs)
	lens = np.sum((pixs[1:] - pixs[:-1])**2, 1)**0.5
	typical = np.median(lens) if len(lens) else 0
	jump = np.where(lens > typical*steplim)[0]
	segs = np.split(pixs, jump + 1)
	def extrap(seg):
		if len(seg) < 2: return seg
		return np.concatenate([seg, [seg[-1] + (seg[-1] - seg[-2])*extrapolate]])
	nseg = len(segs)
	segs = list(segs)
	for i in range(nseg - 1): segs[i] = extrap(segs[i])
	for i in range(1, nseg): segs[i] = extrap(segs[i][::-1])[::-1]
	return segs

def prune_bad_segs(segs, shape, tol=10000):
	"""Drop segments with NaNs or entirely outside the image
	(pixell_tpu.cgrid.prune_bad_segs)."""
	osegs = []
	pmin = -tol
	pmax = np.array([shape[-1], shape[-2]]) + tol
	for seg in segs:
		if len(seg) <= 1: continue
		seg = np.asarray(seg)
		finite = np.all(np.isfinite(seg), 1)
		seg = seg[finite]
		if len(seg) == 0: continue
		inside = np.all((seg >= pmin) & (seg <= pmax), 1)
		left = np.concatenate([[False], inside[:-1]])
		right = np.concatenate([inside[1:], [False]])
		seg = seg[inside | left | right]
		if len(seg) > 1: osegs.append(seg)
	return osegs
