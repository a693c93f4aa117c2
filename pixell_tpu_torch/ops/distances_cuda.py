"""The distance kernels and their wrappers (csrc/distances.cu).

  jump_flood     K13 jump_flood_kernel<I>: the jump flood of nearest-seed
                 indices, one launch a (step, offset) pass (the
                 counterpart of pixell_tpu/distances.py _jump_flood :34-54)
  nearest_point  K14 nearest_point_kernel: the nearest of at most a few
                 thousand points for every pixel, by brute force (the
                 counterpart of distance_from_points' blocked brute force
                 :124-137 and of distance_from_points_healpix's "brute"
                 :286-296)

New kernels of the port: the reference runs both stages in XLA. The state
of the flood is a seed index a pixel (int32, or int64 where the seeds
number 2^31 or more; -1 where none) and a float64 distance. A seed's (dec,
ra) comes from a seed table (tab_dec, tab_ra) or, where none is given, from
the positions of the pixel whose index it is. Positions are float64
tensors broadcastable to the map's [ny, nx]: a separable geometry passes
its dec column and its RA row, which the kernels read through stride 0.

Each wrapper checks its arguments and launches its kernel on CUDA tensors,
adding one to LAUNCHES[name] a launch (jump_flood launches once for the
initial distances and once a pass). On CPU tensors it runs the plain
PyTorch version (PLAIN[name], ops/distances_core.py) instead; on any other
device it raises. There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations
import ctypes
import functools
import torch
from . import _build, distances_core

KERNELS = ("jump_flood", "nearest_point")
LAUNCHES = {name: 0 for name in KERNELS}
PLAIN = {"jump_flood": distances_core.jump_flood_plain, "nearest_point": distances_core.nearest_point_plain}
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0))


def reset_launches():
	for k in LAUNCHES: LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with the K13 and K14 entry points' types
	declared."""
	lib = _build.load()
	P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
	# idx64, seed_in, d_in, seed_out, d_out, pos_dec, pos_ra, dsy, dsx, rsy, rsx, tab_dec, tab_ra,
	# ny, nx, sy, sx, wrapx, init, stream
	lib.pt_jump_flood.argtypes = [I, P, P, P, P, P, P, L, L, L, L, P, P, L, L, L, L, I, I, P]
	lib.pt_jump_flood.restype = I
	# pos_dec, pos_ra, dsy, dsx, rsy, rsx, ny, nx, pt_dec, pt_ra, npt, dist, dom, stream
	lib.pt_nearest_point.argtypes = [P, P, L, L, L, L, L, L, P, P, L, P, P, P]
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


def _positions(name, pos_dec, pos_ra, shape, device):
	"""pos_dec, pos_ra as float64 views of shape [ny, nx] on device, and
	their element strides (dsy, dsx, rsy, rsx)."""
	out = []
	for p in (pos_dec, pos_ra):
		if p.dtype != torch.float64 or p.device != device:
			raise ValueError("%s: positions must be float64 on %s" % (name, device))
		out.append(p.expand(shape))
	return out, (out[0].stride(0), out[0].stride(1), out[1].stride(0), out[1].stride(1))


def _table(name, table, device):
	if table is None: return None
	td, tr = table
	if td.dtype != torch.float64 or tr.dtype != torch.float64 or td.shape != tr.shape or td.ndim != 1 \
			or td.device != device or tr.device != device:
		raise ValueError("%s: the seed table must be two float64 [nseed] tensors on %s" % (name, device))
	return td.contiguous(), tr.contiguous()


def flood_pass(seed, dist, pos_dec, pos_ra, table, sy, sx, wrapx, init=False):
	"""One launch of K13 (one pass; with init the initial distances):
	seed [ny, nx] int32 / int64 and dist [ny, nx] float64 -> the new
	(seed, dist) in new buffers."""
	if seed.ndim != 2 or seed.dtype not in (torch.int32, torch.int64) or not seed.is_contiguous():
		raise ValueError("jump_flood: seed must be a contiguous int32 or int64 [ny, nx] tensor")
	if not init and (dist.shape != seed.shape or dist.dtype != torch.float64 or not dist.is_contiguous()):
		raise ValueError("jump_flood: dist must be a contiguous float64 tensor of seed's shape")
	table = _table("jump_flood", table, seed.device)
	if not _on_card(seed):
		return PLAIN["jump_flood"](seed, dist, pos_dec, pos_ra, table, sy, sx, wrapx, init)
	(pd, pr), strides = _positions("jump_flood", pos_dec, pos_ra, seed.shape, seed.device)
	out_seed, out_dist = torch.empty_like(seed), torch.empty(seed.shape, dtype=torch.float64, device=seed.device)
	_call("jump_flood", seed.device, int(seed.dtype == torch.int64), seed.data_ptr(),
		seed.data_ptr() if init else dist.data_ptr(), out_seed.data_ptr(), out_dist.data_ptr(), pd.data_ptr(),
		pr.data_ptr(), *strides, 0 if table is None else table[0].data_ptr(),
		0 if table is None else table[1].data_ptr(), seed.shape[0], seed.shape[1], int(sy), int(sx),
		int(bool(wrapx)), int(bool(init)))
	return out_seed, out_dist


def jump_flood(seed, pos_dec, pos_ra, wrapx, steps, table=None):
	"""The jump flood of pixell_tpu/distances.py _jump_flood: seed [ny, nx]
	(the index of the pixel's seed, -1 where none) -> (seed, dist) after the
	initial distances and, for each step of steps, the 8 offsets in the
	reference's order, each pass reading the state the last one wrote."""
	s, d = flood_pass(seed, None, pos_dec, pos_ra, table, 0, 0, wrapx, init=True)
	for step in steps:
		for dy, dx in OFFSETS:
			s, d = flood_pass(s, d, pos_dec, pos_ra, table, dy*step, dx*step, wrapx)
	return s, d


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
	(pd, pr), strides = _positions("nearest_point", pos_dec, pos_ra, shape, dev)
	if not _on_card(pt_dec):
		d, dom = PLAIN["nearest_point"](pd, pr, pt_dec, pt_ra, shape)
		return (d, dom) if domains else d
	pt_dec, pt_ra = pt_dec.contiguous(), pt_ra.contiguous()
	d = torch.empty(shape, dtype=torch.float64, device=dev)
	dom = torch.empty(shape, dtype=torch.int32, device=dev) if domains else None
	_call("nearest_point", dev, pd.data_ptr(), pr.data_ptr(), *strides, shape[0], shape[1], pt_dec.data_ptr(),
		pt_ra.data_ptr(), pt_dec.shape[0], d.data_ptr(), 0 if dom is None else dom.data_ptr())
	return (d, dom) if domains else d
