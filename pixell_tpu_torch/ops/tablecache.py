"""One least-recently-used cache for the SHT's tables, bounded by the bytes it
holds instead of by a count of entries.

Every table cache of `sht` and `ops.sht_cuda` shares one budget:
BUDGET_FRACTION of the card's memory (torch.cuda.mem_get_info), or
HOST_BUDGET bytes where there is no card. A new entry evicts the least
recently used entries of any of these caches until the whole fits. So the
tables of many ring sets and bandlimits (a wavelet transform's scales in two
dtypes) stay resident between steps, and the tables of one lmax-10000 f64
transform cannot pile up past the budget."""
from __future__ import annotations
import collections
import functools
import numpy as np
import torch

BUDGET_FRACTION = 0.25
HOST_BUDGET = 1 << 30
CacheInfo = collections.namedtuple("CacheInfo", "hits misses maxsize currsize")

_entries = collections.OrderedDict()   # (function, key) -> (value, bytes)
_held = 0
_budget = None


def budget():
	"""The bytes all the table caches may hold together."""
	global _budget
	if _budget is None:
		_budget = int(BUDGET_FRACTION*torch.cuda.mem_get_info()[1]) if torch.cuda.is_available() else HOST_BUDGET
	return _budget


def held():
	"""The bytes the table caches hold now (keys included)."""
	return _held


def nbytes(x, seen=None):
	"""Bytes of the tensors, arrays and byte strings in x (nested tuples,
	lists and plain objects), each tensor storage counted once."""
	if seen is None: seen = set()
	if isinstance(x, torch.Tensor):
		st = x.untyped_storage()
		key = (x.device, st.data_ptr())
		if key in seen: return 0
		seen.add(key)
		return st.nbytes()
	if isinstance(x, np.ndarray): return x.nbytes
	if isinstance(x, (bytes, bytearray)): return len(x)
	if isinstance(x, (tuple, list)): return sum(nbytes(v, seen) for v in x)
	if hasattr(x, "__dict__"): return sum(nbytes(v, seen) for v in vars(x).values())
	return 0


def _drop(key):
	global _held
	_held -= _entries.pop(key)[1]


def clear():
	"""Empty every table cache."""
	for key in list(_entries): _drop(key)


def cached(fn):
	"""fn(*args, **kwargs) memoised in the shared budget, with the
	cache_info() / cache_clear() of functools.lru_cache."""
	stats = [0, 0]
	@functools.wraps(fn)
	def wrapper(*args, **kwargs):
		global _held
		key = (wrapper, args, tuple(sorted(kwargs.items())))
		if key in _entries:
			_entries.move_to_end(key)
			stats[0] += 1
			return _entries[key][0]
		stats[1] += 1
		value = fn(*args, **kwargs)
		n = nbytes(value) + nbytes(args)
		_entries[key] = (value, n)
		_held += n
		while _held > budget() and len(_entries) > 1:
			_drop(next(iter(_entries)))
		return value
	def cache_info():
		return CacheInfo(stats[0], stats[1], None, sum(k[0] is wrapper for k in _entries))
	def cache_clear():
		for key in [k for k in _entries if k[0] is wrapper]: _drop(key)
		stats[:] = [0, 0]
	wrapper.cache_info, wrapper.cache_clear = cache_info, cache_clear
	return wrapper
