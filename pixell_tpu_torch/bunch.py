"""Bunch: a dict with attribute access (counterpart of pixell_tpu/bunch.py:7)."""
from __future__ import annotations


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
