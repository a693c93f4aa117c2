"""Small batched array operations (counterpart of pixell_tpu/array_ops.py).

Plain tensor operations on their device: batched small-matrix products,
angle to unit vector, per-row rolls, contour labels, matrix powers and
the absolute value of symmetric matrices. Where the reference returns
numpy for numpy input (matmul, matmul_sym, wrap_mm_m's functions,
ang2rect, find_contours, eigpow, eigflip), so does the port: it computes
on the CPU and makes no tensor a caller sees. roll_rows, which the
reference computes on its accelerator, puts host data on device="cuda"
unless told otherwise. The core object of get_core keeps the reference's
interface (the transposed views of its Fortran original), writing into
the output arrays it is given.
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from . import utils


def _rev(x):
	"""x with its axes reversed (numpy's .T for any number of axes)."""
	return x.permute(*range(x.ndim-1, -1, -1)) if isinstance(x, torch.Tensor) else np.asarray(x).T


def _t(x, like=None):
	"""x as a tensor (on like's device)."""
	if isinstance(x, torch.Tensor): return x
	return torch.as_tensor(np.asarray(x), device=None if like is None else like.device)


def _host(fun):
	"""fun, returning numpy where no argument is a tensor or a map."""
	@functools.wraps(fun)
	def wrapped(*args, **kwargs):
		res = fun(*args, **kwargs)
		if any(isinstance(a, torch.Tensor) or hasattr(a, "wcs") for a in args): return res
		return res.numpy() if isinstance(res, torch.Tensor) else res
	return wrapped


def _put(out, res):
	"""res written into out (a tensor or a numpy array), in place."""
	if isinstance(out, torch.Tensor): out.copy_(res)
	else: out[...] = res.cpu().numpy()


class _Core:
	"""The compute core for a dtype (pixell_tpu.array_ops._Core): the
	reference's callables on transposed views, writing into the given
	output (a tensor, or a numpy array from a CPU result)."""
	def __init__(self, dtype):
		self.dtype = dtype
	def matmul_multi(self, AT, BT, XT):
		_put(_rev(XT), torch.einsum("...ij,...kj->...ki", _t(_rev(AT)), _t(_rev(BT))))
	def matmul_multi_sym(self, AT, BT):
		_put(_rev(BT), torch.einsum("...ij,...kj->...ki", _t(_rev(AT)), _t(_rev(BT))))
	def ang2rect(self, aT, resT):
		_put(_rev(resT), torch.movedim(ang2rect(torch.movedim(_t(_rev(aT)), -1, 0)), 0, -1))
	def find_contours(self, imapT, vals, omapT):
		_put(_rev(omapT), find_contours(_t(_rev(imapT)), vals))
	def roll_rows(self, imapT, offsets, omapT):
		_put(_rev(omapT), roll_rows(_t(_rev(imapT)), offsets))


def get_core(dtype):
	"""The compute core for dtype, float32 or float64 (numpy or torch)
	(pixell_tpu.array_ops.get_core)."""
	if isinstance(dtype, torch.dtype): ok = dtype in (torch.float32, torch.float64)
	else: ok = np.dtype(dtype) in (np.float32, np.float64)
	if not ok: raise ValueError("Unsupported data type: %s" % str(dtype))
	return _Core(dtype)


@_host
def matmul(A, b, axes=[-2, -1]):
	"""A [..., n, m] times b [..., m] (or [..., m, k]) with the matrix axes
	of A at axes (pixell_tpu.array_ops.matmul)."""
	A = _t(A); b = _t(b, A)
	ax1, ax2 = [a % A.ndim for a in axes]
	A2 = torch.movedim(A, (ax1, ax2), (-2, -1))
	if b.ndim == A.ndim:
		res = torch.einsum("...ij,...jk->...ik", A2, torch.movedim(b, (ax1, ax2), (-2, -1)))
		return torch.movedim(res, (-2, -1), (ax1, ax2))
	res = torch.einsum("...ij,...j->...i", A2, torch.movedim(b, ax1 % b.ndim, -1))
	return torch.movedim(res, -1, ax1 % b.ndim)


@_host
def matmul_sym(A, b, axes=[-2, -1]):
	"""matmul for a symmetric A."""
	return matmul(A, b, axes=axes)


def wrap_mm_m(name, vec2mat=False):
	"""A function f(A, B, axes=[-2, -1]) that applies the core's matrix
	product name (matmul_multi or matmul_multi_sym) with the matrix axes
	anywhere, keeping B's dtype (pixell_tpu.array_ops.wrap_mm_m)."""
	@_host
	def f(A, B, axes=[-2, -1]):
		return matmul(_t(A), _t(B), axes=axes).to(_t(B).dtype)
	return f


def ang2rect(angs):
	"""[{phi, theta}, ...] angles (theta the latitude) -> [{x, y, z}, ...]
	unit vectors (pixell_tpu.array_ops.ang2rect); a tensor on its device."""
	if not isinstance(angs, torch.Tensor): return utils.ang2rect(angs)
	phi, theta = angs[0], angs[1]
	ct = torch.cos(theta)
	return torch.stack([ct*torch.cos(phi), ct*torch.sin(phi), torch.sin(theta)])


def roll_rows(arr, shifts, *, device="cuda"):
	"""Each row of arr [nrow, n] rolled by its own shift, a tensor on arr's
	device; host data on device (pixell_tpu.array_ops.roll_rows)."""
	arr = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr), device=device)
	shifts = _t(shifts, arr).to(arr.device, torch.int64)
	n = arr.shape[-1]
	idx = (torch.arange(n, device=arr.device)[None, :] - shifts[:, None]) % n
	return torch.gather(arr, -1, idx.expand(arr.shape))


@_host
def find_contours(imap, vals, omap=None):
	"""The index of the contour interval of each pixel: the number of the
	sorted vals below it, as int32 (pixell_tpu.array_ops.find_contours)."""
	arr = imap.data if hasattr(imap, "wcs") else _t(imap)
	vals = _t(vals, arr).to(arr.device)
	dt = torch.promote_types(vals.dtype, arr.dtype)
	res = torch.searchsorted(vals.to(dt), arr.to(dt).contiguous()).to(torch.int32)
	if hasattr(imap, "wcs"):
		from . import enmap
		return enmap.ndmap(res, imap.wcs)
	return res


@_host
def eigpow(A, e, axes=[-2, -1]):
	"""Each symmetric matrix of A (axes) to the power e (utils.eigpow)."""
	return utils.eigpow(_t(A), e, axes=axes)


@_host
def eigflip(A, axes=[-2, -1]):
	"""Each symmetric matrix of A (axes) with its eigenvalues made positive
	(pixell_tpu.array_ops.eigflip)."""
	A = _t(A)
	ax1, ax2 = [a % A.ndim for a in axes]
	E, V = torch.linalg.eigh(torch.movedim(A, (ax1, ax2), (-2, -1)))
	res = torch.einsum("...ij,...j,...kj->...ik", V, E.abs(), V)
	return torch.movedim(res, (-2, -1), (ax1, ax2))
