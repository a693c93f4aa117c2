"""Bunch: a dict with attribute access (counterpart of pixell_tpu/bunch.py:7),
and its HDF5 read / write (:57-87), which pointsrcs' HDF catalogues use."""
from __future__ import annotations
import numpy as np


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
	def update(self, other):
		self._dict.update(other._dict if isinstance(other, Bunch) else other)
		return self
	def copy(self): return Bunch(dict(self._dict))
	def get(self, key, default=None): return self._dict.get(key, default)
	def __repr__(self):
		keys = sorted(self._dict.keys())
		return "Bunch(" + ", ".join("%s=%r" % (k, self._dict[k]) for k in keys) + ")"


def write(fname, bunch):
	"""bunch to an HDF5 file, a group per nested Bunch."""
	import h5py
	with h5py.File(fname, "w") as f:
		_write_group(f, bunch)

def _write_group(g, bunch):
	for k, v in bunch.items():
		if isinstance(v, Bunch): _write_group(g.create_group(k), v)
		elif isinstance(v, str): g[k] = np.bytes_(v)
		else: g[k] = v

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
