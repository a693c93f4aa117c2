"""Named wall-clock timings (counterpart of pixell_tpu/bench.py).

Bench accumulates named timings (mark / show / add / print / set_verbose /
set_tfun, and the module-level default instance whose methods and t / t_tot
/ n views the module re-exports). By default the timer synchronizes the
card before it reads the clock, so that torch's asynchronous launches do
not make the work look free. Each mark keeps one record [count, last,
total]; t, t_tot and n are live views of those records, so the module's
aliases stay current.
"""
from __future__ import annotations
import time
from contextlib import contextmanager
import torch

_print = print


def device_sync():
	"""Wait for the work queued on the current CUDA device; nothing where
	there is no CUDA. An error of the card is raised, not hidden."""
	if torch.cuda.is_available():
		torch.cuda.synchronize()


class _Field:
	"""A live mapping view of one column of a Bench's records."""
	def __init__(self, records, col):
		self._records = records
		self._col = col
	def __getitem__(self, name):
		return self._records[name][self._col]
	def __contains__(self, name):
		return name in self._records
	def __iter__(self):
		return iter(self._records)
	def __len__(self):
		return len(self._records)
	def get(self, name, default=None):
		rec = self._records.get(name)
		return default if rec is None else rec[self._col]
	def items(self):
		for name, rec in self._records.items():
			yield name, rec[self._col]
	def __repr__(self):
		return repr(dict(self.items()))


_NCOL, _LAST, _TOT = 0, 1, 2

class Bench:
	"""Named timings (pixell_tpu.bench.Bench):

	with bench.mark("name"): ...   accumulates
	with bench.show("name"): ...   accumulates and prints
	"""
	def __init__(self, verbose=False, tfun=None, sync=True):
		self._rec = {}
		self.n     = _Field(self._rec, _NCOL)
		self.t     = _Field(self._rec, _LAST)
		self.t_tot = _Field(self._rec, _TOT)
		self.verbose = verbose
		self.tfun = tfun if tfun is not None else time.time
		self.sync = sync
	def _now(self, tfun):
		if self.sync:
			device_sync()
		return tfun()
	@contextmanager
	def _timed(self, name, tfun, loud):
		tfun = tfun or self.tfun
		start = self._now(tfun)
		try:
			yield
		finally:
			self.add(name, self._now(tfun) - start)
			if loud or self.verbose:
				self.print(name)
	def mark(self, name, tfun=None):
		return self._timed(name, tfun, loud=False)
	def show(self, name, tfun=None):
		return self._timed(name, tfun, loud=True)
	def add(self, name, dt):
		rec = self._rec.setdefault(name, [0, 0.0, 0.0])
		rec[_NCOL] += 1
		rec[_LAST] = dt
		rec[_TOT] += dt
	def print(self, name):
		rec = self._rec[name]
		_print("%s: last %.4f s  mean %.4f s  n %d" % (
			name, rec[_LAST], rec[_TOT]/rec[_NCOL], rec[_NCOL]))
	def set_verbose(self, verbose):
		self.verbose = verbose
	def set_tfun(self, tfun):
		self.tfun = tfun
	def stats(self, name):
		rec = self._rec[name]
		from . import bunch
		return bunch.Bunch(last=rec[_LAST], tot=rec[_TOT], n=rec[_NCOL])
	def summary(self):
		"""One line a mark, the longest total first."""
		order = sorted(self._rec, key=lambda k: -self._rec[k][_TOT])
		return "\n".join("%-24s tot %8.4f s  mean %8.4f s  n %4d" % (
			k, self._rec[k][_TOT], self._rec[k][_TOT]/self._rec[k][_NCOL],
			self._rec[k][_NCOL]) for k in order)


# The module-level default instance: its methods and views as module
# attributes (pixell_tpu/bench.py:113-117).
_default = Bench()
for _attr in ("mark show add print t_tot t n set_verbose set_tfun "
		"summary").split():
	globals()[_attr] = getattr(_default, _attr)
del _attr
