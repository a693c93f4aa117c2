"""Angular distance transforms on the sphere (counterpart of
pixell_tpu/distances.py).

The reference replaces pixell's serial C distance kernels by jump flooding
(JFA): a fixed number of data-parallel passes that propagate nearest-seed
candidates at power-of-two offsets, run twice (JFA^2) and closed by steps
2 and 1. Here the flood's passes are K13 (ops/distances_cuda.jump_flood,
one launch a (step, offset) pass, in the reference's order) and the brute
force for few points is K14 (ops/distances_cuda.nearest_point), on the
map's device; CPU tensors take their plain versions
(ops/distances_core.py). The state of the flood is the index of each
pixel's seed: a pixel index where the seeds are pixels (distance_transform,
labeled_distance_transform), a point index into a seed table of the points'
(dec, ra) elsewhere (distance_from_points with more than 1024 points, the
HEALPix "grid" method), so labels and domains are read from the seed
afterwards.

Functions that take a map compute on its device; those that take a
geometry or a HEALPix layout (distance_from_points,
distance_from_points_healpix) on device="cuda" unless told otherwise. The
HEALPix ring structure and the edge finders' neighbour tables are host
numpy, as in the reference.
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from . import enmap, wcsutils
from .ops import distances_cuda
from .ops.distances_core import BIG, shift2d as _shift2d   # BIG: the distance no seed has reached

BRUTE_MAX = 1024   # distance_from_points: the most points the brute force (K14) takes


def _steps_for(n):
	"""The flood's steps for a map of largest side n: powers of two from the
	first >= n down to 1, twice, then 2 and 1 (pixell_tpu/distances.py
	_steps_for)."""
	steps = []
	s = 1
	while s < n: s *= 2
	while s >= 1:
		steps.append(int(s)); s //= 2
	return tuple(steps + steps + [2, 1])

def _is_wrapx(shape, wcs):
	if wcsutils.is_plain(wcs): return False
	return abs(abs(wcs.wcs.cdelt[0])*shape[-1] - 360.0) < 1e-6

def _positions(shape, wcs, device):
	"""(dec, ra) of the pixels as float64 tensors on device broadcastable to
	shape[-2:]: the two axes of a separable geometry, else full maps
	(posmap(safe=False), as the reference)."""
	shape = tuple(shape[-2:])
	if wcsutils.is_separable(wcs):
		dec, ra = enmap.posaxes(shape, wcs, safe=False)
		return (torch.from_numpy(dec).to(device)[:, None], torch.from_numpy(ra).to(device)[None, :])
	pos = enmap.posmap(shape, wcs, safe=False, device=device).data
	return pos[0], pos[1]

def _index_dtype(n):
	return torch.int32 if n < 2**31 else torch.int64

def _pixel_index(shape, device):
	return torch.arange(int(np.prod(shape)), device=device, dtype=_index_dtype(int(np.prod(shape)))).reshape(shape)

def _flood(seed, shape, wcs, table=None):
	pd, pr = _positions(shape, wcs, seed.device)
	return distances_cuda.jump_flood(seed, pd, pr, _is_wrapx(shape, wcs), _steps_for(max(shape[-2:])), table)


def _transform(mask):
	"""(seed mask, the flat index of each pixel's nearest False pixel -- -1
	where there is none --, the flood's distance) of mask."""
	marr = enmap._tensor(mask, "cpu") != 0
	shape = tuple(marr.shape)
	seed = ~marr
	own = _pixel_index(shape, marr.device)
	s, d = _flood(torch.where(seed, own, -1), shape, mask.wcs)
	return seed, torch.where(seed, own, s), d

def distance_transform(mask, rmax=None, return_inds=False):
	"""The angular distance from each pixel to the nearest pixel where mask
	is False (0 inside the False region), on the mask's device; with
	return_inds also that pixel's [{y, x}, ny, nx] int64 index
	(pixell_tpu.distances.distance_transform)."""
	seed, lab, d = _transform(mask)
	d = torch.where(seed, 0.0, d)
	if rmax is not None: d = torch.clamp(d, max=rmax)
	if return_inds:
		nx = lab.shape[-1]
		lab = lab.to(torch.int64)
		inds = torch.stack([torch.div(lab, nx, rounding_mode="floor"), torch.remainder(lab, nx)])
		return enmap.ndmap(d, mask.wcs), inds
	return enmap.ndmap(d, mask.wcs)

def labeled_distance_transform(labels, rmax=None):
	"""The distance from each pixel to the nearest nonzero-labeled pixel,
	and the label of that pixel (its Voronoi domain; 0 where no label
	reaches) (pixell_tpu.distances.labeled_distance_transform)."""
	wcs = labels.wcs
	larr = enmap._tensor(labels, "cpu")
	shape = tuple(larr.shape)
	seed = larr != 0
	s, d = _flood(torch.where(seed, _pixel_index(shape, larr.device), -1), shape, wcs)
	d = torch.where(seed, 0.0, d)
	reached = larr.reshape(-1)[s.clamp(min=0).reshape(-1).to(torch.int64)].reshape(shape)
	dom = torch.where(seed, larr, torch.where(s >= 0, reached, torch.zeros_like(larr)))
	if rmax is not None:
		dom = torch.where(d <= rmax, dom, torch.zeros_like(dom))
		d = torch.clamp(d, max=rmax)
	return enmap.ndmap(d, wcs), enmap.ndmap(dom, wcs)

def _points(points, device):
	"""points [{dec, ra}, n] (numpy or a tensor) as two float64 tensors on
	device."""
	p = points.to(device=device, dtype=torch.float64) if isinstance(points, torch.Tensor) \
		else torch.from_numpy(np.asarray(points, np.float64)).to(device)
	p = p.reshape(2, -1)
	return p[0].contiguous(), p[1].contiguous()

def distance_from_points(shape, wcs, points, rmax=None, domains=False, *, device="cuda"):
	"""The angular distance of each pixel from the nearest of
	points[{dec, ra}, n], with domains also the index of that point (int32;
	-1 where rmax cuts off) (pixell_tpu.distances.distance_from_points).
	Up to BRUTE_MAX points exactly, by K14; more seed the pixel nearest to
	each point (one of several that share a pixel is kept) and flood from
	there, by K13, exact where no two share a pixel."""
	device = points.device if isinstance(points, torch.Tensor) else torch.device(device)
	shape = tuple(shape[-2:])
	pt_dec, pt_ra = _points(points, device)
	npt = pt_dec.shape[0]
	if npt <= BRUTE_MAX:
		pd, pr = _positions(shape, wcs, device)
		res = distances_cuda.nearest_point(pd, pr, pt_dec, pt_ra, shape, domains=domains)
		dmin, dom = res if domains else (res, None)
	else:
		host = np.stack([pt_dec.cpu().numpy(), pt_ra.cpu().numpy()])
		pix = np.round(np.asarray(enmap.sky2pix(shape, wcs, host))).astype(int)
		good = (pix[0] >= 0) & (pix[0] < shape[-2]) & (pix[1] >= 0) & (pix[1] < shape[-1])
		idx = torch.from_numpy(pix[0, good]*shape[-1] + pix[1, good]).to(device)
		seed = torch.full((shape[0]*shape[1],), -1, dtype=_index_dtype(npt), device=device)
		seed[idx] = torch.from_numpy(np.nonzero(good)[0]).to(device=device, dtype=seed.dtype)
		s, dmin = _flood(seed.reshape(shape), shape, wcs, (pt_dec, pt_ra))
		dom = s.to(torch.int32)
	if rmax is not None:
		if domains: dom = torch.where(dmin <= rmax, dom, -1)
		dmin = torch.clamp(dmin, max=rmax)
	if domains:
		return enmap.ndmap(dmin, wcs), enmap.ndmap(dom, wcs)
	return enmap.ndmap(dmin, wcs)

def find_edges(mask):
	"""The pixels on the boundary of the True region of mask, the RA axis
	wrapped (pixell_tpu.distances.find_edges)."""
	m = enmap._tensor(mask, "cpu") != 0
	interior = m
	for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
		interior = interior & _shift2d(m, dy, dx, True, True)
	edges = m & ~interior
	return enmap.ndmap(edges, mask.wcs) if isinstance(mask, enmap.ndmap) else edges

def find_edges_labeled(labels):
	"""The pixels of a nonzero label with a differently labeled neighbour
	(pixell_tpu.distances.find_edges_labeled)."""
	l = enmap._tensor(labels, "cpu")
	edge = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
	for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
		edge = edge | (l != _shift2d(l, dy, dx, True, 0))
	edge = edge & (l != 0)
	return enmap.ndmap(edge, labels.wcs) if isinstance(labels, enmap.ndmap) else edge


# ---------------------------------------------------------------------------
# HEALPix distance transforms (pixell_tpu/distances.py:157-329): the RING
# pixelization embedded in a uniform [nring, 4 nside] grid for the flood
# ("grid"), or the brute force over every pixel and point ("brute")
# ---------------------------------------------------------------------------
class healpix_info:
	"""Ring structure of a HEALPix map: ny rings with nx[y] pixels each,
	first pixel at ra0[y], starting at flat index off[y]
	(pixell_tpu.distances.healpix_info)."""
	def __init__(self, nside):
		from . import healpix
		ri = healpix.ring_info(nside)
		self.nside = int(nside)
		self.npix = healpix.npix(nside)
		self.ny = ri["nring"]
		self.nx = ri["nphi"].astype(np.int64)
		self.off = ri["start"].astype(np.int64)
		self.ra0 = ri["phi0"].copy()
		self.dec = np.pi/2 - ri["theta"]
		self.cos_dec = np.cos(self.dec)
		self.sin_dec = np.sin(self.dec)
		self.shift = (self.ra0 > 0).astype(int)

def unravel_healpix(info, pix1d):
	"""Flat healpix indices -> [{y, x}, ...] ring coordinates."""
	pix1d = np.asarray(pix1d, np.int64)
	y = np.searchsorted(info.off, pix1d, side="right") - 1
	return np.array([y, pix1d - info.off[y]], np.int64)

def ravel_healpix(info, pix2d):
	"""[{y, x}, ...] ring coordinates -> flat healpix indices."""
	pix2d = np.asarray(pix2d, np.int64)
	return info.off[pix2d[0]] + pix2d[1]

def _hp_pos(info, y, x):
	"""(dec, ra) of ring pixels."""
	return info.dec[y], info.ra0[y] + x*(2*np.pi)/info.nx[y]

@functools.lru_cache(maxsize=8)
def _hp_neighbors(nside):
	"""[4, npix] flat neighbour indices (W, E, up-nearest, down-nearest) by
	RA rounding into the adjacent rings; at the poles the missing vertical
	neighbour is the pixel itself."""
	info = healpix_info(nside)
	y = np.repeat(np.arange(info.ny), info.nx)
	x = np.arange(info.npix) - info.off[y]
	nx = info.nx[y]
	west = info.off[y] + (x - 1) % nx
	east = info.off[y] + (x + 1) % nx
	_, ra = _hp_pos(info, y, x)
	def vert(y2):
		ok = (y2 >= 0) & (y2 < info.ny)
		y2c = np.clip(y2, 0, info.ny - 1)
		nx2 = info.nx[y2c]
		x2 = np.round((ra - info.ra0[y2c])*nx2/(2*np.pi)).astype(np.int64) % nx2
		return np.where(ok, info.off[y2c] + x2, info.off[y] + x)
	return np.stack([west, east, vert(y - 1), vert(y + 1)])

def get_healpix_neighs(info, y, x):
	"""[{y, x}, 4] neighbours of ring pixel (y, x)."""
	n = _hp_neighbors(info.nside)[:, info.off[y] + x]
	return unravel_healpix(info, n)

def find_edges_healpix(info, mask, flat=True):
	"""The pixels of the zero region of mask next to a nonzero pixel (host
	numpy, pixell_tpu.distances.find_edges_healpix)."""
	m = enmap._host_array(mask).reshape(-1) != 0
	neigh = _hp_neighbors(info.nside)
	edge = ~m & (m[neigh[0]] | m[neigh[1]] | m[neigh[2]] | m[neigh[3]])
	idx = np.where(edge)[0]
	return idx if flat else unravel_healpix(info, idx)

def find_edges_labeled_healpix(info, labels, flat=True):
	"""The pixels on the edge of a nonzero same-label region (host numpy)."""
	l = enmap._host_array(labels).reshape(-1)
	neigh = _hp_neighbors(info.nside)
	edge = (l != 0) & ((l != l[neigh[0]]) | (l != l[neigh[1]]) | (l != l[neigh[2]]) | (l != l[neigh[3]]))
	idx = np.where(edge)[0]
	return idx if flat else unravel_healpix(info, idx)

def _hp_pixels(info, device):
	"""(y, x) [npix] int64 ring coordinates of every pixel, made on device
	from the per-ring counts."""
	nx = torch.from_numpy(info.nx).to(device)
	y = torch.repeat_interleave(torch.arange(info.ny, device=device), nx, output_size=info.npix)
	return y, torch.arange(info.npix, device=device) - torch.from_numpy(info.off).to(device)[y]

def _hp_ring_ra(info, y, x, device):
	"""The RA of ring pixels (y, x) (int64 tensors on device), as _hp_pos
	computes it."""
	ra0 = torch.from_numpy(info.ra0).to(device)[y]
	nx = torch.from_numpy(info.nx).to(device)[y]
	return ra0 + x.to(torch.float64)*(2*np.pi)/nx.to(torch.float64)

def distance_from_points_healpix(info, point_pos, point_pix=None, rmax=None, omap=None, odomains=None,
		domains=False, method="auto", *, device="cuda"):
	"""The distance from each HEALPix pixel to the nearest of the points
	point_pos[{dec, ra}, npoint], float64 [npix] on device; with domains
	also the index of that point (int32 [npix]; -1 where rmax cuts off)
	(pixell_tpu.distances.distance_from_points_healpix). method: "brute"
	(exact, K14), "grid" (K13 on the uniform ring embedding; "bubble" and
	"heap" are its aliases), "auto" (brute up to 2e8 pixel-point pairs).
	"grid" reads each pixel at a cell of its own position, where the
	reference may read a neighbour's."""
	device = torch.device(device)
	point_pos = enmap._host_array(point_pos).astype(float).reshape(2, -1)
	npoint = point_pos.shape[1]
	if method == "auto":
		method = "brute" if npoint*info.npix <= 2e8 else "grid"
	if method in ("bubble", "heap"): method = "grid"
	pt_dec, pt_ra = _points(point_pos, device)
	if method == "brute":
		y, x = _hp_pixels(info, device)
		pd = torch.from_numpy(info.dec).to(device)[y][None]
		pr = _hp_ring_ra(info, y, x, device)[None]
		d, lab = distances_cuda.nearest_point(pd, pr, pt_dec, pt_ra, (1, info.npix))
		d, lab = d[0], lab[0]
	else:
		W = 4*info.nside
		ny = info.ny
		yg = torch.arange(ny, device=device)[:, None]
		xg = torch.arange(W, device=device)[None, :]*torch.from_numpy(info.nx).to(device)[yg]//W
		gdec, gra = torch.from_numpy(info.dec).to(device)[yg], _hp_ring_ra(info, yg, xg, device)
		if point_pix is None:
			from . import healpix
			point_pix = healpix.ang2pix(info.nside, np.pi/2 - point_pos[0], point_pos[1])
		point_pix = np.asarray(point_pix)
		if point_pix.ndim == 1: point_pix = unravel_healpix(info, point_pix)
		py, px = point_pix[0], point_pix[1]
		cg = ((2*px + 1)*W)//(2*info.nx[py])
		seed = torch.full((ny*W,), -1, dtype=_index_dtype(npoint), device=device)
		seed[torch.from_numpy(py*W + cg).to(device)] = torch.arange(npoint, dtype=seed.dtype, device=device)
		s, dg = distances_cuda.jump_flood(seed.reshape(ny, W), gdec, gra, True, _steps_for(max(ny, W)),
			(pt_dec, pt_ra))
		# read each pixel back at the first cell whose position is its own,
		# ceil(x W / nx) (the reference reads the cell of its centre,
		# (2 x + 1) W // (2 nx), which on rings of fewer than W pixels can
		# hold a neighbour's position: ROADMAP Queue 3)
		yv, xv = _hp_pixels(info, device)
		cell = yv*W - torch.div(-xv*W, torch.from_numpy(info.nx).to(device)[yv], rounding_mode="floor")
		d = dg.reshape(-1)[cell]
		lab = s.reshape(-1)[cell].to(torch.int32)
	if rmax is not None and rmax > 0:
		lab = torch.where(d > rmax, -1, lab)
		d = torch.clamp(d, max=rmax)
	if omap is not None: omap[:] = d; d = omap
	if odomains is not None: odomains[:] = lab; lab = odomains
	return (d, lab) if domains else d
