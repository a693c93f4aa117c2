"""Devices and their memory (counterpart of pixell_tpu/device.py).

A Device wraps a torch.device: transfers to it and back to host numpy,
synchronization, synchronized timing, and memory figures. DeviceGpu is a
CUDA device with a stream of its own, on which put() copies host data (from
pinned memory, so the copy overlaps work on the current stream, which waits
for it before using the result); its memuse reads torch.cuda's allocator
(memory_stats) and the CUDA runtime (mem_get_info). DeviceTpu is bound to it, so
that a call written for the reference still works. DeviceCpu keeps tensors
on the host. A Workspace holds named long-lived tensors that a pipeline
reuses in place, so that a steady state runs at a constant footprint.

Not ported (ROADMAP "Not ported"): enable_compilation_cache, jax's
persistent cache of compiled programs, and donating_jit, XLA's buffer
donation: torch writes into a buffer in place (out=, in-place operators),
which Workspace.ensure hands out.
"""
from __future__ import annotations
import gc
import time
import numpy as np
import torch


class Device:
	"""One torch device and the services the library needs from it."""
	kind = "abstract"
	def __init__(self, dev=None, index=0):
		self.dev = torch.device(dev) if dev is not None else torch.device("cuda", index)
		self.workspaces = {}
	# --- transfers ---
	def put(self, arr):
		"""Host data, a tensor or an ndmap on this device (an ndmap stays one)."""
		from . import enmap
		if isinstance(arr, enmap.ndmap): return enmap.ndmap(self.put(arr.data), arr.wcs)
		if not isinstance(arr, torch.Tensor): arr = torch.as_tensor(np.asarray(arr))
		return arr.to(self.dev)
	def get(self, arr):
		"""A tensor or an ndmap as host numpy."""
		from . import enmap
		return enmap._host_array(arr)
	# --- execution ---
	def synchronize(self):
		"""Wait until all work queued on this device has finished."""
	def time(self):
		"""Wall time after a device sync, for timing device work."""
		self.synchronize()
		return time.perf_counter()
	def garbage_collect(self):
		gc.collect()
	# --- memory ---
	def memuse(self, type="total"):
		"""Bytes in use: "total" (live tensors), "peak" or "workspaces" (held
		by this device's Workspace objects)."""
		if type == "workspaces":
			return sum(w.nbytes for w in self.workspaces.values())
		raise ValueError("unknown memory type '%s'" % type)
	def workspace(self, name):
		"""The named Workspace on this device (made on first use)."""
		if name not in self.workspaces:
			self.workspaces[name] = Workspace(self)
		return self.workspaces[name]
	@property
	def np(self):
		"""The array module of this device's data: torch."""
		return torch
	def __repr__(self):
		return "%s(%s)" % (self.__class__.__name__, self.dev)


class DeviceCpu(Device):
	"""The host: tensors on the CPU, memory figures of the process."""
	kind = "cpu"
	def __init__(self, dev=None):
		super().__init__("cpu" if dev is None else dev)
	def memuse(self, type="total"):
		"""The process's memory ("total", "peak"), or the workspaces'."""
		if type == "workspaces": return super().memuse(type)
		from . import memory
		return memory.max() if type == "peak" else memory.current()


class DeviceGpu(Device):
	"""A CUDA device with a stream of its own for host-to-device copies."""
	kind = "gpu"
	def __init__(self, dev=None, index=0):
		super().__init__(dev, index)
		self.stream = torch.cuda.Stream(self.dev)
	def put(self, arr):
		"""Host data on this device, copied on the device's stream from pinned
		memory; the current stream waits for the copy."""
		from . import enmap
		if isinstance(arr, enmap.ndmap): return enmap.ndmap(self.put(arr.data), arr.wcs)
		if isinstance(arr, torch.Tensor) and arr.device.type != "cpu": return arr.to(self.dev)
		host = torch.as_tensor(arr if isinstance(arr, torch.Tensor) else np.asarray(arr))
		if not host.is_pinned(): host = host.pin_memory()
		with torch.cuda.stream(self.stream):
			out = host.to(self.dev, non_blocking=True)
		torch.cuda.current_stream(self.dev).wait_stream(self.stream)
		out.record_stream(torch.cuda.current_stream(self.dev))
		return out
	def synchronize(self):
		torch.cuda.synchronize(self.dev)
	def garbage_collect(self):
		gc.collect()
		torch.cuda.empty_cache()
	def memuse(self, type="total"):
		"""Bytes: "total" in live tensors and "peak" their most, from
		torch.cuda.memory_stats; "device" in use on the card by every
		process (mem_get_info); or the workspaces'."""
		if type == "workspaces": return super().memuse(type)
		if type == "device":
			free, total = torch.cuda.mem_get_info(self.dev)
			return total - free
		key = {"total": "allocated_bytes.all.current", "peak": "allocated_bytes.all.peak"}[type]
		return int(torch.cuda.memory_stats(self.dev).get(key, 0))

# the accelerator of the reference's TPU runtime is this one
DeviceTpu = DeviceGpu


def get_device(name="auto", index=0):
	"""A Device: "auto" is "gpu" where CUDA is present, else "cpu"; "gpu",
	"cuda" and "tpu" the CUDA device index."""
	if name == "auto":
		name = "gpu" if torch.cuda.is_available() else "cpu"
	if name == "cpu":
		return DeviceCpu()
	if name in ("gpu", "cuda", "tpu"):
		return DeviceGpu(index=index)
	raise ValueError("unknown device '%s'" % name)


def anypy(arr):
	"""The array module that made arr: torch for a tensor or an ndmap, else numpy."""
	from . import enmap
	return torch if isinstance(arr, (torch.Tensor, enmap.ndmap)) else np


class Workspace:
	"""Named long-lived tensors on a device. take removes and returns one
	(the caller now owns it), give stores one under a name, and ensure
	returns a zeroed tensor of the shape and dtype asked for, zeroing the
	stored one in place where it matches, so that a step repeated with the
	same shapes allocates nothing."""
	def __init__(self, device=None):
		self.device = device if device is not None else get_device()
		self._bufs = {}
	def give(self, name, arr):
		self._bufs[name] = arr
		return arr
	def take(self, name, default=None):
		return self._bufs.pop(name, default)
	def peek(self, name, default=None):
		return self._bufs.get(name, default)
	def ensure(self, name, shape, dtype=np.float32):
		"""A zeroed tensor of shape and dtype on the device: the stored one,
		zeroed in place, where it matches."""
		from .enmap import _torch_dtype
		dtype = _torch_dtype(dtype)
		cur = self._bufs.get(name)
		shape = tuple(shape)
		if cur is not None and tuple(cur.shape) == shape and cur.dtype == dtype:
			out = cur.zero_()
		else:
			out = torch.zeros(shape, dtype=dtype, device=self.device.dev)
		self._bufs[name] = out
		return out
	def drop(self, name):
		self._bufs.pop(name, None)
	def clear(self):
		self._bufs.clear()
	@property
	def nbytes(self):
		return sum(b.numel()*b.element_size() for b in self._bufs.values())
	def names(self):
		return sorted(self._bufs)
	def __contains__(self, name):
		return name in self._bufs
	def __repr__(self):
		body = ", ".join("%s%s" % (n, tuple(self._bufs[n].shape)) for n in self.names())
		return "Workspace(%d bytes: %s)" % (self.nbytes, body)
