"""WatchArray: numpy arrays that print a traceback on writes, a debugging
aid (counterpart of pixell_tpu/warray.py, whole: host numpy)."""
from __future__ import annotations
import numpy as np
import traceback, sys


class WatchArray(np.ndarray):
	"""ndarray subclass announcing every write."""
	def __new__(cls, arr, name="warray", file=sys.stderr):
		obj = np.asarray(arr).view(cls)
		obj.name = name
		obj.file = file
		return obj
	def __array_finalize__(self, obj):
		if obj is None: return
		self.name = getattr(obj, "name", "warray")
		self.file = getattr(obj, "file", sys.stderr)
	def _announce(self, what):
		self.file.write("WatchArray %s: %s\n" % (self.name, what))
		traceback.print_stack(file=self.file)
	def __setitem__(self, sel, val):
		self._announce("__setitem__ %s" % str(sel))
		return np.ndarray.__setitem__(self, sel, val)
	def fill(self, val):
		self._announce("fill %s" % str(val))
		return np.ndarray.fill(self, val)
	def copy(self, order="C"):
		"""Copy back to a plain ndarray."""
		return np.asarray(self).copy(order)

def watch(arr, name="warray"):
	return WatchArray(arr, name=name)
