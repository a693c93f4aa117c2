"""Checkpoints and resumption (counterpart of pixell_tpu/checkpoint.py).

save_pytree / load_pytree keep a nested structure of dicts, lists and
tuples of tensors (and numpy arrays, numbers, strings, ndmaps) in one file
by torch.save, read back by torch.load(weights_only=True) onto a device:
the reference's orbax directories become a file. A numpy array comes back
as a CPU tensor placed like the rest, an ndmap as an ndmap. save_solver /
load_solver go through utils.CG's (or a solver's own) save / load, HDF5;
save_map / load_map through enmap, a map being its own checkpoint.
"""
from __future__ import annotations
import os
import numpy as np
import torch

_NDMAP = "__pixell_ndmap__"


def _plain(tree):
	"""tree with what torch.load(weights_only=True) refuses made plain: an
	ndmap a dict of its data and wcs header, a numpy array a tensor."""
	from . import enmap
	if isinstance(tree, enmap.ndmap): return {_NDMAP: tree.data.detach(), "wcs": tree.wcs.to_header()}
	if isinstance(tree, np.ndarray): return torch.from_numpy(np.ascontiguousarray(tree))
	if isinstance(tree, np.generic): return tree.item()
	if isinstance(tree, dict): return {k: _plain(v) for k, v in tree.items()}
	if isinstance(tree, (list, tuple)): return type(tree)(_plain(v) for v in tree)
	return tree


def _restore(tree, like=None):
	"""The inverse of _plain; each tensor placed (device, dtype) as the leaf
	of like in its place, where like is given."""
	from . import enmap, wcsutils
	if isinstance(tree, dict) and _NDMAP in tree:
		data = _restore(tree[_NDMAP], like.data if isinstance(like, enmap.ndmap) else None)
		return enmap.ndmap(data, wcsutils.WCS(header=tree["wcs"]))
	if isinstance(tree, dict): return {k: _restore(v, None if like is None else like[k]) for k, v in tree.items()}
	if isinstance(tree, (list, tuple)):
		return type(tree)(_restore(v, None if like is None else like[i]) for i, v in enumerate(tree))
	if isinstance(tree, torch.Tensor) and isinstance(like, (torch.Tensor, enmap.ndmap)):
		ref = like.data if isinstance(like, enmap.ndmap) else like
		return tree.to(device=ref.device, dtype=ref.dtype)
	return tree


def save_pytree(path, tree, force=True):
	"""tree (nested dicts, lists and tuples of tensors, numpy arrays,
	numbers, strings and ndmaps) to the file path; an existing file is
	replaced only with force."""
	path = os.path.abspath(path)
	if os.path.exists(path) and not force: raise FileExistsError(path)
	tmp = path + ".%d.tmp" % os.getpid()
	torch.save(_plain(tree), tmp)
	os.replace(tmp, path)


def load_pytree(path, like=None, *, device="cuda"):
	"""The tree save_pytree wrote, its tensors on device, or where given,
	each on the device and in the dtype of the leaf of like in its place."""
	tree = torch.load(os.path.abspath(path), weights_only=True, map_location="cpu" if like is not None else device)
	return _restore(tree, like)


def save_solver(fname, solver):
	"""The solver's state (utils.CG's x, r, p, rz, rz0, i) to an HDF5 file."""
	solver.save(fname)


def load_solver(fname, solver):
	"""solver with the state of save_solver's file, ready to step on."""
	solver.load(fname)
	return solver


def save_map(fname, map):
	"""A map is its own checkpoint: enmap.write_map."""
	from . import enmap
	enmap.write_map(fname, map)


def load_map(fname, *, device="cuda"):
	from . import enmap
	return enmap.read_map(fname, device=device)
