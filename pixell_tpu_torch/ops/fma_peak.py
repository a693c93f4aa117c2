"""K9: the FMA-peak microbenchmark and its wrapper.

Counterpart of scripts/vpu_peak.py (main :21, pallas_call :58), the TPU
vector unit's ceiling. The kernel is pixell_tpu_torch/csrc/fma_peak.cu:
every element of x runs iters steps of x = x*c + d as a fused multiply-add,
in registers, and the chain's end is written out. Its rate in operations
per second (2 per step and element) is the card's measured FP32 or FP64
FMA ceiling, which anchors the roofline shares of the other kernels. No
SHT path calls it.

fma_peak launches the kernel on a CUDA tensor, adding one to LAUNCHES, and
runs the plain PyTorch version (plain) on a CPU tensor; any other device
raises.
"""
from __future__ import annotations
import ctypes
import functools
import torch
from . import _build

LAUNCHES = {"fma_peak": 0}


@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with the K9 entry point's types declared."""
	lib = _build.load()
	lib.pt_fma_peak.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
		ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
	lib.pt_fma_peak.restype = ctypes.c_int
	lib.pt_fma_peak_block_elems.argtypes = []
	lib.pt_fma_peak_block_elems.restype = ctypes.c_int
	return lib


def plain(x, c, d, iters):
	"""The same chain in PyTorch: x*c + d, which rounds twice per step."""
	y = x.clone()
	for _ in range(iters): y = y*c + d
	return y


def operations(x, iters):
	"""Floating-point operations of one call: 2 per step and element."""
	return 2*x.numel()*iters


def fma_peak(x, c, d, iters):
	"""x [n] float32 or float64, contiguous -> [n], each element after iters
	steps of x = fma(x, c, d); c and d are Python floats, iters >= 0."""
	if x.dtype not in (torch.float32, torch.float64):
		raise TypeError("fma_peak: dtype %s, expected float32 or float64" % x.dtype)
	if x.ndim != 1 or not x.is_contiguous():
		raise ValueError("fma_peak: x must be a contiguous 1-d tensor")
	if not isinstance(iters, int) or iters < 0 or iters >= 2**31:
		raise ValueError("fma_peak: iters must be an int in [0, 2^31)")
	c, d = float(c), float(d)
	if x.device.type == "cpu": return plain(x, c, d, iters)
	if x.device.type != "cuda":
		raise RuntimeError("no fma_peak kernel for device '%s'" % x.device)
	out = torch.empty_like(x)
	with torch.cuda.device(x.device):
		err = library().pt_fma_peak(int(x.dtype == torch.float64), x.data_ptr(), out.data_ptr(),
			c, d, iters, x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
	if err != 0:
		raise RuntimeError("fma_peak kernel launch failed: CUDA error %d" % err)
	LAUNCHES["fma_peak"] += 1
	return out
