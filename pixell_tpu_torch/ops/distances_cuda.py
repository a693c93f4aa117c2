"""The distance kernels and their wrappers (csrc/distances.cu).

  jump_flood     K13 jump_flood_kernel<I, SEP>: the jump flood of nearest-seed
                 indices, one launch a (step, offset) pass and one to
                 finish (the counterpart of pixell_tpu/distances.py
                 _jump_flood :34-54)
  nearest_point  K14 nearest_point_kernel<SEP>: the nearest of at most a few
                 thousand points for every pixel, by brute force (the
                 counterpart of distance_from_points' blocked brute force
                 :124-137 and of distance_from_points_healpix's "brute"
                 :286-296)

New kernels of the port: the reference runs both stages in XLA. The state
of the flood is a seed index a pixel (int32, or int64 where the seeds
number 2^31 or more; -1 where none); its distance is computed once, after
the last pass. A seed's (dec, ra) comes from a seed table (tab_dec, tab_ra)
or, where none is given, from the positions of the pixel whose index it
is. Positions are float64 tensors broadcastable to the map's [ny, nx]: a
separable geometry passes its dec column and its RA row.

The kernels compare unit vectors and take the Vincenty angle only where two
dot products lie within MARGIN (below) and for the distances they write, so
their results are the plain versions' bit for bit. Each call makes the
tables they read once (tables), in the positions' own broadcast shapes
(read through stride 0): (sin dec, cos dec) pairs, ra and (cos ra, sin ra)
pairs, and for a seed table or the points [n, 4] unit vectors and [n, 3]
(ra, sin dec, cos dec) (point_tables).

Each wrapper checks its arguments and launches its kernel on CUDA tensors,
adding one to LAUNCHES[name] a launch (jump_flood launches once a pass and
once to finish). On CPU tensors it runs the plain PyTorch version
(PLAIN[name], ops/distances_core.py) instead; on any other device it
raises. There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations
import ctypes
import functools
from typing import NamedTuple, Optional
import torch
from . import _build, distances_core

KERNELS = ("jump_flood", "nearest_point")
LAUNCHES = {name: 0 for name in KERNELS}
PLAIN = {"jump_flood": distances_core.jump_flood_plain, "flood_finish": distances_core.flood_finish_plain,
	"nearest_point": distances_core.nearest_point_plain}
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0))

# MARGIN, M: the kernels decide "c is nearer than b" to a pixel P by the dot
# products dc = P.C, db = P.B of float64 unit vectors where dc > db + M (c
# nearer) or dc < db - M (c not nearer), and by the two Vincenty angles,
# strict <, in between. With u = 2^-53 and every quantity at most ~1 in size
# (an ulp at most 2u; RA within [-2 pi, 2 pi], so ra2 - ra1 below 16):
#
# - the unit vectors (cos dec cos ra, cos dec sin ra, sin dec): sin and cos
#   by torch on the card (CUDA's, within 2 ulp: 2u each), a component a
#   product of two rounded once (4.5u), so a vector is off by at most
#   |(4.5, 4.5, 2)|u = 6.7u;
# - the dot product of two such vectors, a multiply and two FMAs
#   (__dmul_rn, __fma_rn), against the exact cosine of the angle between
#   the two float64 positions: the vectors' errors move it by at most
#   2 x 6.7u, the three roundings by at most 3u: e_dot = 17u;
# - Vincenty's angle of the same positions (the kernels' and the plain
#   versions' arithmetic): ra2 - ra1 rounds once (8u; the angle moves by at
#   most cos(dec2) times that), the sin and cos of the decs and of dra (2u
#   each), six products and two sums (u/2 to u each) and hypot (2 ulp) put
#   x off by 12.5u and y by 17.3u, which turns atan2's argument by at most
#   |(12.5, 17.3)|u = 21.4u; atan2 adds 2 ulp of an angle up to pi (8u):
#   e_ang = 8u + 21.4u + 8u = 38u.
#
# If dc > db + M, the exact cosines differ by more than M - 2 e_dot - u (the
# sum db + M rounds once), and since |cos a - cos b| <= |a - b| (the
# cosine's slope is at most 1), the exact angles by as much: the computed
# angles then differ by more than M - 2 e_dot - 2 e_ang - u = M - 111u > 0,
# in the same direction, so c is nearer by strict < of the angles as well.
# The same holds for dc < db - M the other way. K14's scan looks at a point
# only where a filter lets it through: f = dot - thr (thr = db - M,
# rounded once: within u) from one chain of FMAs in another order, on a
# separable geometry cos dec a + e with a = cos ra cx + sin ra cy and
# e = sin dec cz - thr (a's product and FMA within 2u, e's FMA within 2u
# as |e| < 4), else e1 = qx cx - thr, e2 = qy cy + e1 (within 2u each) and
# f = qz cz + e2, q the pixel's unit vector. A
# point is dropped where f's sign bit is set, so where the exact value
# the last FMA rounds is <= 0 (rounding keeps the sign): the exact
# dot - thr is then at most 4u, and dc, with its own roundings (5u on a
# separable geometry, whose vector components round too; 3u else), less
# thr at most 9u. So a point is dropped only where dc < db - M + 10u,
# M - 10u - 2 e_dot - 2 e_ang = M - 120u > 0 from the best, where the
# angles would not take it either. So the kernels' decisions are the
# angles' own, ties and point order included. M = 2^-43 = 1024u is more
# than ten times e_dot + e_ang = 55u; tests/test_torch_distances_margin.py
# holds the two errors together below M / 10 on a million pairs (random,
# near-antipodal, under 1e-7 rad, mirrored ties at pixel centres) and the
# filter's 9u on pairs at their threshold, its FMAs emulated.
MARGIN = 2.0**-43


def reset_launches():
	for k in LAUNCHES: LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with the K13 and K14 entry points' types
	declared."""
	lib = _build.load()
	P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
	# idx64, seed_in, seed_out, d_out, dec_sc, dsy, dsx, ra, ra_cs, rsy, rsx, vec, sph, ny, nx, sy, sx,
	# wrapx, margin, stream
	lib.pt_jump_flood.argtypes = [I, P, P, P, P, L, L, P, P, L, L, P, P, L, L, L, L, I, D, P]
	lib.pt_jump_flood.restype = I
	# dec_sc, dsy, dsx, ra, ra_cs, rsy, rsx, ny, nx, vec, sph, npt, margin, dist, dom, stream
	lib.pt_nearest_point.argtypes = [P, L, L, P, P, L, L, L, L, P, P, L, D, P, P, P]
	lib.pt_nearest_point.restype = I
	return lib


def _on_card(x):
	if x.device.type == "cuda": return True
	if x.device.type == "cpu": return False
	raise RuntimeError("no distance kernel for device '%s'" % x.device)


def _call(name, device, *args):
	# the C entry points launch on the thread's current device
	with torch.cuda.device(device):
		err = getattr(library(), "pt_" + name)(*args, torch.cuda.current_stream(device).cuda_stream)
	if err != 0:
		raise RuntimeError("%s kernel launch failed: CUDA error %d" % (name, err))
	LAUNCHES[name] += 1


def _check_positions(name, pos_dec, pos_ra, shape, device):
	for p in (pos_dec, pos_ra):
		if p.dtype != torch.float64 or p.device != device:
			raise ValueError("%s: positions must be float64 on %s" % (name, device))
		p.expand(shape)


def _compact(p):
	"""p with each broadcast (stride 0) axis cut to one element, contiguous."""
	for ax in range(p.ndim):
		if p.stride(ax) == 0 and p.shape[ax] > 1: p = p.narrow(ax, 0, 1)
	return p.contiguous()


class Tables(NamedTuple):
	"""What the kernels read of the positions, each in its positions' own
	broadcast shape and viewed as [ny, nx] (stride 0 on a broadcast axis):
	dec_sc [ny, nx, 2] (sin dec, cos dec), ra [ny, nx] and ra_cs [ny, nx, 2]
	(cos ra, sin ra); strides (dsy, dsx, rsy, rsx), dec_sc's in pairs, ra's
	and ra_cs' (in elements and in pairs, alike); and a seed table's or the
	points' [n, 4] unit vectors (x, y, z, 0) and [n, 3] (ra, sin dec, cos
	dec), or None."""
	dec_sc: torch.Tensor
	ra: torch.Tensor
	ra_cs: torch.Tensor
	strides: tuple
	vec: Optional[torch.Tensor]
	sph: Optional[torch.Tensor]


def point_tables(dec, ra):
	"""[n, 4] unit vectors (cos dec cos ra, cos dec sin ra, sin dec, 0) and
	[n, 3] (ra, sin dec, cos dec) of the points (dec, ra) [n]."""
	sd, cd = torch.sin(dec), torch.cos(dec)
	vec = torch.stack([cd*torch.cos(ra), cd*torch.sin(ra), sd, torch.zeros_like(sd)], 1)
	return vec.contiguous(), torch.stack([ra, sd, cd], 1).contiguous()


def tables(name, pos_dec, pos_ra, shape, device, points=None):
	"""The Tables of the positions (broadcastable to shape [ny, nx], float64
	on device) and of points (dec, ra), or of none."""
	_check_positions(name, pos_dec, pos_ra, shape, device)
	d, r = _compact(pos_dec.expand(shape)), _compact(pos_ra.expand(shape))
	dsc = torch.stack([torch.sin(d), torch.cos(d)], -1).expand(shape + (2,))
	rcs = torch.stack([torch.cos(r), torch.sin(r)], -1).expand(shape + (2,))
	ra = r.expand(shape)   # its strides are ra_cs' in pairs: both made contiguous from r
	vec, sph = (None, None) if points is None else point_tables(*points)
	return Tables(dsc, ra, rcs, (dsc.stride(0)//2, dsc.stride(1)//2, ra.stride(0), ra.stride(1)), vec, sph)


def _pixel_args(t):
	dsy, dsx, rsy, rsx = t.strides
	return (t.dec_sc.data_ptr(), dsy, dsx, t.ra.data_ptr(), t.ra_cs.data_ptr(), rsy, rsx)


def _table(name, table, device):
	if table is None: return None
	td, tr = table
	if td.dtype != torch.float64 or tr.dtype != torch.float64 or td.shape != tr.shape or td.ndim != 1 \
			or td.device != device or tr.device != device:
		raise ValueError("%s: the seed table must be two float64 [nseed] tensors on %s" % (name, device))
	return td.contiguous(), tr.contiguous()


def _check_seed(seed):
	if seed.ndim != 2 or seed.dtype not in (torch.int32, torch.int64) or not seed.is_contiguous():
		raise ValueError("jump_flood: seed must be a contiguous int32 or int64 [ny, nx] tensor")


def flood_pass(seed, tabs, sy, sx, wrapx, out=None):
	"""One pass of K13 on the card: seed [ny, nx] int32 / int64 -> the
	seeds after the pass of offset (sy, sx), in out (a buffer like seed,
	not seed itself) or a new one. tabs: tables(...) of the map's positions
	and seed table."""
	out = torch.empty_like(seed) if out is None else out
	_call("jump_flood", seed.device, int(seed.dtype == torch.int64), seed.data_ptr(), out.data_ptr(), 0,
		*_pixel_args(tabs), 0 if tabs.vec is None else tabs.vec.data_ptr(),
		0 if tabs.sph is None else tabs.sph.data_ptr(), seed.shape[0], seed.shape[1], int(sy), int(sx),
		int(bool(wrapx)), MARGIN)
	return out


def flood_finish(seed, tabs):
	"""K13's last launch: the angle [ny, nx] float64 from each pixel to its
	seed, BIG where it has none."""
	d = torch.empty(seed.shape, dtype=torch.float64, device=seed.device)
	_call("jump_flood", seed.device, int(seed.dtype == torch.int64), seed.data_ptr(), 0, d.data_ptr(),
		*_pixel_args(tabs), 0 if tabs.vec is None else tabs.vec.data_ptr(),
		0 if tabs.sph is None else tabs.sph.data_ptr(), seed.shape[0], seed.shape[1], 0, 0, 0, MARGIN)
	return d


def jump_flood(seed, pos_dec, pos_ra, wrapx, steps, table=None):
	"""The jump flood of pixell_tpu/distances.py _jump_flood: seed [ny, nx]
	(the index of the pixel's seed, -1 where none) -> (seed, dist) after,
	for each step of steps, the 8 offsets in the reference's order, each
	pass reading the seeds the last one wrote; dist is the angle to the
	final seed (BIG where none)."""
	_check_seed(seed)
	table = _table("jump_flood", table, seed.device)
	passes = [(dy*step, dx*step) for step in steps for dy, dx in OFFSETS]
	if not _on_card(seed):
		s = seed
		for sy, sx in passes: s = PLAIN["jump_flood"](s, pos_dec, pos_ra, table, sy, sx, wrapx)
		return s, PLAIN["flood_finish"](s, pos_dec, pos_ra, table)
	tabs = tables("jump_flood", pos_dec, pos_ra, seed.shape, seed.device, table)
	bufs = [torch.empty_like(seed), torch.empty_like(seed)]   # ping-pong; seed itself is not written
	s = seed
	for i, (sy, sx) in enumerate(passes):
		s = flood_pass(s, tabs, sy, sx, wrapx, bufs[i % 2])
	return s.clone() if s is seed else s, flood_finish(s, tabs)


def nearest_point(pos_dec, pos_ra, pt_dec, pt_ra, shape, domains=True):
	"""K14: the distance [ny, nx] float64 from each pixel to the nearest of
	the points (pt_dec, pt_ra) [npt] float64 and, with domains, its index
	[ny, nx] int32 (the first of equal distances; BIG and 0 where npt is
	0). Positions broadcastable to shape, on the points' device."""
	dev = pt_dec.device
	if pt_dec.dtype != torch.float64 or pt_ra.dtype != torch.float64 or pt_dec.shape != pt_ra.shape \
			or pt_dec.ndim != 1 or pt_ra.device != dev:
		raise ValueError("nearest_point: the points must be two float64 [npt] tensors on one device")
	shape = tuple(int(n) for n in shape)
	if len(shape) != 2: raise ValueError("nearest_point: shape must be [ny, nx]")
	if not _on_card(pt_dec):
		_check_positions("nearest_point", pos_dec, pos_ra, shape, dev)
		d, dom = PLAIN["nearest_point"](pos_dec.expand(shape), pos_ra.expand(shape), pt_dec, pt_ra, shape)
		return (d, dom) if domains else d
	tabs = tables("nearest_point", pos_dec, pos_ra, shape, dev, (pt_dec, pt_ra))
	d = torch.empty(shape, dtype=torch.float64, device=dev)
	dom = torch.empty(shape, dtype=torch.int32, device=dev) if domains else None
	_call("nearest_point", dev, *_pixel_args(tabs), shape[0], shape[1], tabs.vec.data_ptr(), tabs.sph.data_ptr(),
		pt_dec.shape[0], MARGIN, d.data_ptr(), 0 if dom is None else dom.data_ptr())
	return (d, dom) if domains else d
