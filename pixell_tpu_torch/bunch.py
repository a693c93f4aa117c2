"""Bunch: a dict with attribute access, and its HDF5 IO (counterpart of
pixell_tpu/bunch.py, all of it).

read / write store a Bunch as an HDF5 file, a group per nested Bunch;
read_hdf / write_hdf take a path that may name a group inside the file
('cat.hdf/sources'), and encode strings and None for storage. Host numpy
and h5py: a tensor is stored from the host and read back as numpy.
concatenate joins tensors on their device, anything else with numpy.
"""
from __future__ import annotations
import os
import numpy as np
import torch


class Bunch:
	def __init__(self, *args, **kwargs):
		self._dict = {}
		for a in args:
			self._dict.update(a if isinstance(a, dict) else a._dict)
		self._dict.update(kwargs)
	def __getattr__(self, name):
		if name.startswith("_"): raise AttributeError(name)
		try: return self.__dict__["_dict"][name]
		except KeyError: raise AttributeError(name)
	def __setattr__(self, name, val):
		if name == "_dict": return object.__setattr__(self, name, val)
		self._dict[name] = val
	def __delattr__(self, name):
		del self._dict[name]
	def __getitem__(self, name): return self._dict[name]
	def __setitem__(self, name, val): self._dict[name] = val
	def __delitem__(self, name): del self._dict[name]
	def __contains__(self, name): return name in self._dict
	def __iter__(self): return iter(self._dict)
	def __len__(self): return len(self._dict)
	def keys(self): return self._dict.keys()
	def values(self): return self._dict.values()
	def items(self): return self._dict.items()
	def iteritems(self): return iter(self._dict.items())
	def update(self, other):
		self._dict.update(other._dict if isinstance(other, Bunch) else other)
		return self
	def copy(self): return Bunch(dict(self._dict))
	def get(self, key, default=None): return self._dict.get(key, default)
	def setdefault(self, key, default=None): return self._dict.setdefault(key, default)
	def __repr__(self):
		keys = sorted(self._dict.keys())
		return "Bunch(" + ", ".join("%s=%s" % (k, _brepr(self._dict[k])) for k in keys) + ")"

def _brepr(v):
	if isinstance(v, (np.ndarray, torch.Tensor)): return "array[%s]" % ",".join(map(str, v.shape))
	return repr(v)


def concatenate(bunches):
	"""A Bunch of the entries of several bunches with the same keys, each
	concatenated along its first axis (tensors by torch, on their device)."""
	res = Bunch()
	for k in bunches[0].keys():
		vals = [b[k] for b in bunches]
		if all(isinstance(v, torch.Tensor) for v in vals):
			res[k] = torch.cat([torch.atleast_1d(v) for v in vals])
		else:
			res[k] = np.concatenate([np.atleast_1d(np.asarray(v)) for v in vals])
	return res


def _store(v):
	"""v as h5py stores it: a tensor from the host."""
	return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def write(fname, bunch):
	"""bunch to an HDF5 file, a group per nested Bunch."""
	import h5py
	with h5py.File(fname, "w") as f:
		_write_group(f, bunch)

def _write_group(g, bunch):
	for k, v in bunch.items():
		if isinstance(v, Bunch): _write_group(g.create_group(k), v)
		elif isinstance(v, str): g[k] = np.bytes_(v)
		else: g[k] = _store(v)

def read(fname, group=None):
	"""The Bunch an HDF5 file (or its group) holds."""
	import h5py
	with h5py.File(fname, "r") as f:
		return _read_group(f[group] if group else f)

def _read_group(g):
	import h5py
	res = Bunch()
	for k, v in g.items():
		if isinstance(v, h5py.Group):
			res[k] = _read_group(v)
		else:
			val = v[()]
			res[k] = val.decode() if isinstance(val, bytes) else val
	return res


# ---------------------------------------------------------------------------
# HDF5 IO with a group in the path (pixell_tpu/bunch.py:88-184)
# ---------------------------------------------------------------------------
def is_hdf_path(fname):
	"""Whether fname looks like an HDF5 path, possibly with a /group suffix."""
	try:
		split_hdf_path(fname)
		return True
	except ValueError:
		return False

def split_hdf_path(fname, subgroup=None, mode="dot"):
	"""'path.hdf/group' as (path, group). mode "dot": the last component
	with a dot in it ends the file name; "exists": the longest prefix that
	is a file; "none": no split."""
	if mode == "none": return fname, subgroup
	toks = fname.split("/")
	if mode == "dot":
		for i, tok in reversed(list(enumerate(toks))):
			if "." in tok: break
		else:
			raise ValueError("Could not split hdf path using 'dot' method: no . found")
	elif mode == "exists":
		for i in reversed(range(len(toks))):
			cand = "/".join(toks[:i+1])
			if os.path.isfile(cand): break
		else:
			raise ValueError("Could not split hdf path: no existing file found")
	else:
		raise ValueError("Unknown split mode '%s'" % mode)
	fname2 = "/".join(toks[:i+1])
	group = "/".join(toks[i+1:]) or None
	if subgroup:
		group = group + "/" + subgroup if group else subgroup
	return fname2, group

def encode(val):
	"""Strings (and arrays of them) as bytes and None as "__None__", for HDF5."""
	if isinstance(val, np.ndarray):
		try: return np.char.encode(val)
		except (TypeError, AttributeError): return val
	if isinstance(val, str): return val.encode()
	if val is None: return "__None__".encode()
	return _store(val)

def decode(val):
	"""The inverse of encode."""
	if isinstance(val, np.ndarray):
		try: return np.char.decode(val)
		except (TypeError, AttributeError): return val
	if isinstance(val, bytes):
		val = val.decode()
		if val == "__None__": return None
		return val
	return val

def read_hdf(fname, group=None, gmode="dot"):
	"""A Bunch from an HDF5 file (its group, where the path or group names
	one) or from an open file or group."""
	import h5py
	if isinstance(fname, (h5py.Group, h5py.File)):
		node = fname[group] if group is not None else fname
		return read_hdf_recursive(node)
	if group is None:
		fname, group = split_hdf_path(fname, group, mode=gmode)
	with h5py.File(fname, "r") as hfile:
		node = hfile[group] if group else hfile
		return read_hdf_recursive(node)

def read_hdf_recursive(hfile):
	import h5py
	if isinstance(hfile, h5py.Dataset):
		return decode(hfile[()])
	res = Bunch()
	for key in hfile:
		res[key] = read_hdf_recursive(hfile[key])
	return res

def write_hdf(fname, bunch, group=None, gmode="dot"):
	import h5py
	if group is None:
		fname, group = split_hdf_path(fname, group, mode=gmode)
	with h5py.File(fname, "w") as hfile:
		node = hfile.create_group(group) if group else hfile
		write_hdf_recursive(node, bunch)

def write_hdf_recursive(hfile, bunch):
	for key in bunch:
		if isinstance(bunch[key], Bunch):
			hfile.create_group(key)
			write_hdf_recursive(hfile[key], bunch[key])
		else:
			hfile[key] = encode(bunch[key])
