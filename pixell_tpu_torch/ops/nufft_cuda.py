"""The NUFFT point-stage kernels and their wrappers (csrc/nufft.cu).

  u2nu_points  K10 u2nu_points_kernel<T, COMPLEX>: each point's ES-weighted
               sum over its w x w window of a fine grid [C, nfy, nfx], real
               or complex (the counterpart of pixell_tpu/fft.py
               _u2nu_2d_core_split :391 and _u2nu_2d_core :379)
  nu2u_spread  K11 nu2u_spread_kernel<T, COMPLEX>: its transpose, each
               point's value spread onto its window with atomicAdd (the
               counterpart of _nu2u_2d_core :610)

New kernels of the port: the reference runs this stage in XLA. T is float
or double, the fine grid's (or the values') real precision; the point
coordinates are float64 [npt, 2] whatever T is.

Each wrapper checks its arguments and launches its kernel on a CUDA tensor,
adding one to LAUNCHES[name] and to LAUNCHES_BY_DTYPE[(name, "float32" or
"float64", "real" or "complex")]. On a CPU tensor it runs its plain PyTorch
version (PLAIN[name], ops/nufft_core.py, the same arguments) instead; on any
other device it raises.
"""
from __future__ import annotations
import ctypes
import functools
import torch
from . import _build, nufft_core

WMAX = 16   # the largest kernel width the kernels take (csrc/nufft.cu WMAX)
KERNELS = ("u2nu_points", "nu2u_spread")
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_DTYPE = {(name, dt, kind): 0 for name in KERNELS for dt in ("float32", "float64")
	for kind in ("real", "complex")}
PLAIN = {"u2nu_points": nufft_core.u2nu_points_plain, "nu2u_spread": nufft_core.nu2u_spread_plain}


def reset_launches():
	for d in (LAUNCHES, LAUNCHES_BY_DTYPE):
		for k in d: d[k] = 0


@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with the K10 and K11 entry points' types
	declared."""
	lib = _build.load()
	P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
	for fn in (lib.pt_u2nu_points, lib.pt_nu2u_spread):
		# f64, complex, in, coords, out, C, nfy, nfx, npt, pery, perx, w, beta, stream
		fn.argtypes = [I, I, P, P, P, I, I, I, ctypes.c_longlong, D, D, I, D, P]
		fn.restype = I
	lib.pt_nufft_wmax.argtypes, lib.pt_nufft_wmax.restype = [], I
	if lib.pt_nufft_wmax() != WMAX:
		raise RuntimeError("the built NUFFT kernels take w <= %d, not %d" % (lib.pt_nufft_wmax(), WMAX))
	return lib


def _on_card(x):
	if x.device.type == "cuda": return True
	if x.device.type == "cpu": return False
	raise RuntimeError("no NUFFT kernel for device '%s'" % x.device)


def _check(name, x, coords, nfine, w):
	"""The checks both kernels share: x float or complex of either
	precision and contiguous, coords float64 [npt, 2] contiguous on x's
	device, 2 <= w <= min(WMAX, nfy, nfx)."""
	if x.dtype not in (torch.float32, torch.float64, torch.complex64, torch.complex128):
		raise TypeError("%s: dtype %s, expected float32/64 or complex64/128" % (name, x.dtype))
	if not x.is_contiguous(): raise ValueError("%s: the grid or values must be contiguous" % name)
	if coords.dtype != torch.float64 or coords.ndim != 2 or coords.shape[1] != 2 \
			or not coords.is_contiguous():
		raise ValueError("%s: coords must be a contiguous float64 [npt, 2] tensor" % name)
	if coords.device != x.device:
		raise ValueError("%s: coords on %s, data on %s" % (name, coords.device, x.device))
	if not (2 <= int(w) <= min(WMAX, int(nfine[0]), int(nfine[1]))):
		raise ValueError("%s: kernel width %d outside [2, %d]" % (name, w, min(WMAX, *nfine)))


def _launch(name, x, coords, out, nfine, periodicity, w, beta):
	f64 = x.real.dtype == torch.float64 if x.is_complex() else x.dtype == torch.float64
	with torch.cuda.device(x.device):
		err = getattr(library(), "pt_" + name)(int(f64), int(x.is_complex()), x.data_ptr(),
			coords.data_ptr(), out.data_ptr(), x.shape[0], int(nfine[0]), int(nfine[1]),
			coords.shape[0], float(periodicity[0]), float(periodicity[1]), int(w), float(beta),
			torch.cuda.current_stream(x.device).cuda_stream)
	if err != 0:
		raise RuntimeError("%s kernel launch failed: CUDA error %d" % (name, err))
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
