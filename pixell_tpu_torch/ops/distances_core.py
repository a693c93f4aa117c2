"""Plain PyTorch versions of the distance kernels (csrc/distances.cu).

  jump_flood_plain     K13's pass: one (step, offset) pass of the jump
                       flood over a map of nearest-seed indices
  flood_finish_plain   K13's last launch: the angle from each pixel to its
                       seed
  nearest_point_plain  K14: the nearest of a list of points for every
                       pixel, by brute force

The CPU path of pixell_tpu_torch.distances runs these, and chip_smoke.py
holds the kernels against them on the card. All take positions as float64
tensors broadcastable to the map's [ny, nx] (a separable geometry passes
its dec column [ny, 1] and its RA row [1, nx]) and compute the angle by
Vincenty's formula in utils.angdist's order of operations
(pixell_tpu/utils.py:245-258), in float64; they compare angles, where the
kernels compare unit vectors and fall back on these angles within a
margin (ops/distances_cuda.py MARGIN).
"""
from __future__ import annotations
import torch

BIG = 1e30   # the distance of a pixel no seed has reached (pixell_tpu/distances.py:19)
BLOCK = 128  # points a block of nearest_point_plain, as the reference's brute force


def vincenty(ra1, dec1, ra2, dec2):
	"""The angle between (ra1, dec1) and (ra2, dec2), broadcasting, in
	utils.angdist's order of operations."""
	return vincenty_sc(ra1, torch.sin(dec1), torch.cos(dec1), ra2, torch.sin(dec2), torch.cos(dec2))


def vincenty_sc(ra1, s1, c1, ra2, s2, c2):
	"""vincenty with the sin and cos of both decs given (the kernels read
	them from tables)."""
	dra = ra2 - ra1
	cd = torch.cos(dra)
	y = torch.hypot(c2*torch.sin(dra), c1*s2 - s1*c2*cd)
	x = s1*s2 + c1*c2*cd
	return torch.atan2(y, x)


def seed_positions(seed, pos_dec, pos_ra, table, shape):
	"""(dec, ra) of the seeds seed (indices >= 0): rows of table (dec, ra)
	where one is given, else the pixels of index seed (row-major) of the
	map of shape [ny, nx]."""
	if table is not None: return table[0][seed], table[1][seed]
	return (pos_dec.expand(shape).reshape(-1)[seed], pos_ra.expand(shape).reshape(-1)[seed])


def shift2d(a, sy, sx, wrapx, fill):
	"""a [ny, nx] shifted by (sy, sx) as pixell_tpu/distances.py _shift2d
	does it: rows never wrap (a shift of ny or more fills every row),
	columns wrap modulo nx where wrapx, else fill too."""
	ny, nx = a.shape
	if abs(sy) >= ny: return torch.full_like(a, fill)
	res = torch.roll(a, (sy, sx), (0, 1))
	if sy > 0: res[:sy] = fill
	elif sy < 0: res[sy:] = fill
	if not wrapx:
		if sx > 0: res[:, :sx] = fill
		elif sx < 0: res[:, sx:] = fill
	return res


def jump_flood_plain(seed, pos_dec, pos_ra, table, sy, sx, wrapx):
	"""One pass of K13. seed [ny, nx] (int32 or int64; -1 where none) ->
	the seeds after the pass of offset (sy, sx): each pixel takes the seed
	of the pixel (y - sy, x - sx) where that one is nearer than its own, by
	strict < of the angles (a tie keeps the pixel's seed; a pixel without a
	seed takes any). The angles are computed where a candidate differs from
	the pixel's seed, its own angle again each pass."""
	cand = shift2d(seed, sy, sx, wrapx, -1)
	ev = (cand >= 0) & (cand != seed)
	out = seed.clone()
	own, c = seed[ev], cand[ev]
	pd, pr = pos_dec.expand(seed.shape)[ev], pos_ra.expand(seed.shape)[ev]
	od, orr = seed_positions(own.clamp(min=0), pos_dec, pos_ra, table, seed.shape)
	cd, cr = seed_positions(c, pos_dec, pos_ra, table, seed.shape)
	d_own = torch.where(own >= 0, vincenty(pr, pd, orr, od), BIG)
	out[ev] = torch.where(vincenty(pr, pd, cr, cd) < d_own, c, own)
	return out


def flood_finish_plain(seed, pos_dec, pos_ra, table):
	"""K13's finish: the angle [ny, nx] float64 from each pixel to its seed,
	BIG where the seed is -1."""
	pd, pr = pos_dec.expand(seed.shape), pos_ra.expand(seed.shape)
	cd, cr = seed_positions(seed.clamp(min=0), pos_dec, pos_ra, table, seed.shape)
	return torch.where(seed >= 0, vincenty(pr, pd, cr, cd), BIG)


def nearest_point_plain(pos_dec, pos_ra, pt_dec, pt_ra, shape):
	"""K14: for each pixel of shape [ny, nx] at (pos_dec, pos_ra), the
	distance to the nearest of the points (pt_dec, pt_ra) [npt] and its
	index, the first of equal distances (strict < in point order); BIG and
	0 where there is no point."""
	pd = pos_dec.expand(shape).reshape(-1, 1)
	pr = pos_ra.expand(shape).reshape(-1, 1)
	dmin = torch.full((pd.shape[0],), BIG, dtype=torch.float64, device=pd.device)
	dom = torch.zeros(pd.shape[0], dtype=torch.int32, device=pd.device)
	for i0 in range(0, pt_dec.shape[0], BLOCK):
		d = vincenty(pr, pd, pt_ra[None, i0:i0+BLOCK], pt_dec[None, i0:i0+BLOCK])
		bd, bi = torch.min(d, 1)
		better = bd < dmin
		dmin = torch.where(better, bd, dmin)
		dom = torch.where(better, bi.to(torch.int32) + i0, dom)
	return dmin.reshape(shape), dom.reshape(shape)
