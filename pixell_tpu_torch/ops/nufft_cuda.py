"""The NUFFT point-stage kernels and their wrappers (csrc/nufft.cu).

  u2nu_points  K10 u2nu_points_kernel<T, COMPLEX>: each point's ES-weighted
               sum over its w x w window of a fine grid [C, nfy, nfx], real
               or complex (the counterpart of pixell_tpu/fft.py
               _u2nu_2d_core_split :391 and _u2nu_2d_core :379)
  nu2u_spread  K11 nu2u_spread_kernel<T, COMPLEX>: its transpose, each
               point's value spread onto its window (the counterpart of
               _nu2u_2d_core :610)
  tile_keys    K12 tile_keys_kernel<T, K>: each point's key for the binning
               both take, the fine-grid tile of its first tap (no
               counterpart: the reference does not bin)

New kernels of the port: the reference runs this stage in XLA. T is float
or double, the fine grid's (or the values') real precision; the point
coordinates are float64 [npt, 2] whatever T is.

Both kernels take the points binned by fine-grid tile (bins:
nufft_core.bin_points on K12's keys, a stable sort and the subproblems'
ranges, torch operations on the card): one block takes one subproblem, at
most CAP points of one TILE, with the tile and its halo of w - 1 cells in
shared memory. K10 copies the padded tile from the grid and sums each
point's window there, in the first design's order of arithmetic, so its
results are bit-reproducible. K11, a warp a block, adds its points'
contributions into the padded tile in shared memory, a point at a time with
the lanes on distinct taps (no shared-memory atomics: for double they are a
compare-and-swap loop), and adds the tile onto the grid with one atomicAdd
per cell: its sums change order from run to run. What bounds both on the
H100 is the ES weights and shared memory (csrc/nufft.cu's header). The
binning is a sort of all the points; bins keeps the last BINS_CACHE point
sets' bins, so that calls at the same points (a geometry's pixels, a
rotation's grid, K10 and K11 on one point set) bin once.

Each wrapper checks its arguments and launches its kernel on a CUDA tensor,
adding one to LAUNCHES[name] and to LAUNCHES_BY_DTYPE[(name, "float32" or
"float64", "real" or "complex"; for tile_keys the key's "int16" or
"int32")]. On a CPU tensor it runs its plain PyTorch
version (PLAIN[name], ops/nufft_core.py, the same arguments) instead; on any
other device it raises.
"""
from __future__ import annotations
import collections
import ctypes
import functools
import torch
from . import _build, nufft_core

WMAX = 16   # the largest kernel width the kernels take (csrc/nufft.cu WMAX)
TILE = (32, 32)           # fine cells of a tile, rows by columns
CAP = 1024                # points of a subproblem at most
POINTS_SMEM = 48 << 10    # K10: shared memory the staged components of a block may take
SPREAD_SMEM = 56 << 10    # K11: the same for its tile and buffers (four blocks an SM)
BINS_CACHE = 2            # point sets whose bins bins keeps
KERNELS = ("u2nu_points", "nu2u_spread", "tile_keys")
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_DTYPE = {(name, dt, kind): 0 for name in KERNELS for dt in ("float32", "float64")
	for kind in (("int16", "int32") if name == "tile_keys" else ("real", "complex"))}
PLAIN = {"u2nu_points": nufft_core.u2nu_points_plain, "nu2u_spread": nufft_core.nu2u_spread_plain,
	"tile_keys": nufft_core.tile_keys}


def reset_launches():
	for d in (LAUNCHES, LAUNCHES_BY_DTYPE):
		for k in d: d[k] = 0


def components(spread, C, esize, r, w, lib=None):
	"""The components a block takes at a time: the most of C whose shared
	memory fits the kernel's budget (POINTS_SMEM, SPREAD_SMEM), at least
	one; for K10 at most the library's pt_nufft_point_cmax (its sums are in
	registers). The shared memory of a block is the library's own count
	(pt_nufft_smem_bytes) for esize-byte reals, r of them a value; lib is
	the built library by default."""
	lib = library() if lib is None else lib
	budget = SPREAD_SMEM if spread else POINTS_SMEM
	cc = C if spread else min(C, lib.pt_nufft_point_cmax())
	while cc > 1 and lib.pt_nufft_smem_bytes(int(spread), int(esize == 8), int(r == 2), cc, int(w),
			*TILE) > budget:
		cc -= 1
	return cc


@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with the K10, K11 and K12 entry points'
	types declared."""
	return declare(_build.load())


def declare(lib):
	"""lib (a library built from csrc/nufft.cu) with the K10, K11 and K12
	entry points' types declared, checked to take w <= WMAX."""
	P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
	# f64, complex, in, coords, perm, subs, nsub, out, C, cc, nfy, nfx, npt, pery, perx, w, beta,
	# ty, tx, stream
	lib.pt_u2nu_points.argtypes = lib.pt_nu2u_spread.argtypes = [I, I, P, P, P, P, L, P, I, I, I, I, L,
		D, D, I, D, I, I, P]
	lib.pt_u2nu_points.restype = lib.pt_nu2u_spread.restype = I
	# f64, key bytes, coords, keys, npt, nfy, nfx, pery, perx, w, ty, tx, offset, stream
	lib.pt_tile_keys.argtypes = [I, I, P, P, L, I, I, D, D, I, I, I, I, P]
	lib.pt_tile_keys.restype = I
	lib.pt_nufft_wmax.argtypes, lib.pt_nufft_wmax.restype = [], I
	lib.pt_nufft_point_cmax.argtypes, lib.pt_nufft_point_cmax.restype = [], I
	# spread, f64, complex, cc, w, ty, tx
	lib.pt_nufft_smem_bytes.argtypes, lib.pt_nufft_smem_bytes.restype = [I]*7, L
	if lib.pt_nufft_wmax() != WMAX:
		raise RuntimeError("the built NUFFT kernels take w <= %d, not %d" % (lib.pt_nufft_wmax(), WMAX))
	return lib


def _on_card(x):
	if x.device.type == "cuda": return True
	if x.device.type == "cpu": return False
	raise RuntimeError("no NUFFT kernel for device '%s'" % x.device)


def _stream(x):
	"""The current CUDA stream of x's device, as the entry points take it."""
	return torch.cuda.current_stream(x.device).cuda_stream


def _call(name, device, *args):
	# the C entry points launch on the thread's current device
	with torch.cuda.device(device):
		err = getattr(library(), "pt_" + name)(*args)
	if err != 0:
		raise RuntimeError("%s kernel launch failed: CUDA error %d" % (name, err))


def _check_coords(name, coords, nfine, w):
	"""The checks the three kernels share: coords float64 [npt, 2]
	contiguous, 2 <= w <= min(WMAX, nfy, nfx)."""
	if coords.dtype != torch.float64 or coords.ndim != 2 or coords.shape[1] != 2 \
			or not coords.is_contiguous():
		raise ValueError("%s: coords must be a contiguous float64 [npt, 2] tensor" % name)
	if not (2 <= int(w) <= min(WMAX, int(nfine[0]), int(nfine[1]))):
		raise ValueError("%s: kernel width %d outside [2, %d]" % (name, w, min(WMAX, *nfine)))


def _check(name, x, coords, nfine, w):
	"""The checks K10 and K11 share: x float or complex of either
	precision and contiguous, on coords' device, and _check_coords."""
	if x.dtype not in (torch.float32, torch.float64, torch.complex64, torch.complex128):
		raise TypeError("%s: dtype %s, expected float32/64 or complex64/128" % (name, x.dtype))
	if not x.is_contiguous(): raise ValueError("%s: the grid or values must be contiguous" % name)
	_check_coords(name, coords, nfine, w)
	if coords.device != x.device:
		raise ValueError("%s: coords on %s, data on %s" % (name, coords.device, x.device))


def tile_keys(coords, nfine, periodicity, w, dtype, tile):
	"""K12: coords [npt, 2] float64 -> [npt] keys (nufft_core.key_format)
	for nufft_core.bin_points: the tile of tile = (Ty, Tx) fine cells of the
	grid nfine that holds each point's first tap, its fraction in dtype."""
	if dtype not in (torch.float32, torch.float64):
		raise TypeError("tile_keys: fraction dtype %s, expected float32 or float64" % dtype)
	_check_coords("tile_keys", coords, nfine, w)
	if not _on_card(coords): return PLAIN["tile_keys"](coords, nfine, periodicity, w, dtype, tile)
	ntiles = -(-int(nfine[0])//int(tile[0]))*-(-int(nfine[1])//int(tile[1]))
	kdt, offset = nufft_core.key_format(ntiles)
	keys = torch.empty(coords.shape[0], dtype=kdt, device=coords.device)
	f64 = dtype == torch.float64
	_call("tile_keys", coords.device, int(f64), keys.element_size(), coords.data_ptr(), keys.data_ptr(),
		coords.shape[0], int(nfine[0]), int(nfine[1]), float(periodicity[0]), float(periodicity[1]),
		int(w), int(tile[0]), int(tile[1]), offset, _stream(coords))
	LAUNCHES["tile_keys"] += 1
	LAUNCHES_BY_DTYPE[("tile_keys", "float64" if f64 else "float32", str(kdt)[6:])] += 1
	return keys


_BINS = collections.OrderedDict()   # bins' cache: key -> (the coords it holds on to, Bins)


def clear_bins():
	"""Empty bins' cache."""
	_BINS.clear()


def bins(coords, nfine, periodicity, w, dtype):
	"""The points coords [npt, 2] float64 binned for K10 and K11 on the grid
	nfine, their fractions in dtype: nufft_core.bin_points on K12's keys
	(tile_keys), by TILE and CAP. The bins of the last BINS_CACHE point sets
	are kept, keyed by the coords' memory (data pointer, shape, strides) and
	version counter and by the binning's arguments: the cache holds a
	reference to coords, so that memory holds these points until the entry
	goes, and an in-place write to them bumps the version."""
	key = None if coords.is_inference() else (coords.device, coords.data_ptr(), tuple(coords.shape),
		coords.stride(), coords._version, tuple(int(n) for n in nfine), float(periodicity[0]),
		float(periodicity[1]), int(w), dtype)
	hit = _BINS.get(key)
	if hit is not None:
		_BINS.move_to_end(key)
		return hit[1]
	b = nufft_core.bin_points(coords, nfine, periodicity, w, dtype, TILE, CAP,
		keys=tile_keys(coords, nfine, periodicity, w, dtype, TILE))
	if key is not None:
		_BINS[key] = (coords, b)
		while len(_BINS) > BINS_CACHE: _BINS.popitem(last=False)
	return b


def _launch(name, x, coords, out, nfine, periodicity, w, beta):
	"""Launch the kernel name on the points binned by tile (bins): a block
	per subproblem, components(...) components at a time."""
	f64 = x.real.dtype == torch.float64 if x.is_complex() else x.dtype == torch.float64
	spread = name == "nu2u_spread"
	C = x.shape[0]
	cc = components(spread, C, 8 if f64 else 4, 2 if x.is_complex() else 1, w)
	b = bins(coords, nfine, periodicity, w, torch.float64 if f64 else torch.float32)
	_call(name, x.device, int(f64), int(x.is_complex()), x.data_ptr(), coords.data_ptr(),
		b.perm.data_ptr(), b.subs.data_ptr(), b.subs.shape[0], out.data_ptr(), C, cc,
		int(nfine[0]), int(nfine[1]), coords.shape[0], float(periodicity[0]), float(periodicity[1]),
		int(w), float(beta), TILE[0], TILE[1], _stream(x))
	LAUNCHES[name] += 1
	LAUNCHES_BY_DTYPE[(name, "float64" if f64 else "float32", "complex" if x.is_complex()
		else "real")] += 1


def u2nu_points(fine, coords, periodicity, w, beta):
	"""K10: fine [C, nfy, nfx] float or complex, coords [npt, 2] float64
	(y, x) in units of periodicity (pery, perx) -> [C, npt] of fine's
	dtype: each point's ES-weighted sum over its w x w window, wrapped
	periodically."""
	if fine.ndim != 3: raise ValueError("u2nu_points: fine must be [C, nfy, nfx]")
	_check("u2nu_points", fine, coords, fine.shape[1:], w)
	if not _on_card(fine): return PLAIN["u2nu_points"](fine, coords, periodicity, w, beta)
	out = fine.new_empty((fine.shape[0], coords.shape[0]))
	_launch("u2nu_points", fine, coords, out, fine.shape[1:], periodicity, w, beta)
	return out


def nu2u_spread(vals, coords, nfine, periodicity, w, beta):
	"""K11: vals [C, npt] float or complex, coords [npt, 2] float64 -> the
	fine grid [C, nfy, nfx] of vals' dtype: the transpose of u2nu_points,
	its sums in an order that changes from run to run (atomics)."""
	if vals.ndim != 2 or vals.shape[1] != coords.shape[0]:
		raise ValueError("nu2u_spread: vals must be [C, npt] with npt the coords' count")
	_check("nu2u_spread", vals, coords, nfine, w)
	if not _on_card(vals): return PLAIN["nu2u_spread"](vals, coords, nfine, periodicity, w, beta)
	fine = vals.new_zeros((vals.shape[0], int(nfine[0]), int(nfine[1])))
	_launch("nu2u_spread", vals, coords, fine, nfine, periodicity, w, beta)
	return fine
