"""Process and device memory introspection (counterpart of
pixell_tpu/memory.py). The process's figures come from /proc (Linux) or
getrusage; the device's from torch.cuda's allocator."""
from __future__ import annotations
import sys


def _proc_status(field):
	try:
		with open("/proc/self/status") as f:
			for line in f:
				if line.startswith(field):
					return int(line.split()[1])*1024
	except IOError:
		return 0
	return 0

def current():
	"""Current virtual memory use in bytes."""
	return _proc_status("VmSize")

def resident():
	"""Current resident memory in bytes."""
	return _proc_status("VmRSS")

def max():
	"""Peak virtual memory use in bytes."""
	return _proc_status("VmPeak")

def max_resident():
	"""Peak resident memory in bytes."""
	return _proc_status("VmHWM")

def device_memory():
	"""(live, peak) bytes of tensors on the current CUDA device, from
	torch.cuda's allocator; (0, 0) without a CUDA device."""
	import torch
	if not torch.cuda.is_available(): return 0, 0
	return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()

def trace(msg=""):
	"""Print an annotated memory snapshot of the process and the device."""
	dev_live, dev_peak = device_memory()
	sys.stderr.write("mem %8.3f GB cur %8.3f GB res %8.3f GB peak | dev %8.3f GB live %8.3f GB peak %s\n" % (
		current()/1e9, resident()/1e9, max()/1e9, dev_live/1e9, dev_peak/1e9, msg))


def fallback(things, default=lambda: 0):
	"""The result of the first callable in things that does not raise."""
	for thing in things:
		try: return thing()
		except Exception: continue
	return default()

def linux_current():
	"""Current memory use from /proc."""
	with open("/proc/self/status") as f:
		for line in f:
			if line.startswith("VmSize:"):
				return int(line.split()[1])*1024
	raise OSError("VmSize not found")

def linux_resident():
	with open("/proc/self/status") as f:
		for line in f:
			if line.startswith("VmRSS:"):
				return int(line.split()[1])*1024
	raise OSError("VmRSS not found")

def linux_max():
	with open("/proc/self/status") as f:
		for line in f:
			if line.startswith("VmPeak:"):
				return int(line.split()[1])*1024
	raise OSError("VmPeak not found")

def get_mac_taskinfo():
	raise OSError("mac taskinfo not available on this platform")

def mac_current():
	import resource
	return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

def mac_resident():
	return mac_current()

def mac_max():
	return mac_current()

class MemUse:
	"""The resident memory across a with-block, printed at its end unless
	verbose is False."""
	def __init__(self, name="", verbose=True):
		self.name = name
		self.verbose = verbose
	def __enter__(self):
		self.start = fallback([linux_resident, mac_resident])
		return self
	def __exit__(self, type, value, traceback):
		self.stop = fallback([linux_resident, mac_resident])
		self.diff = self.stop - self.start
		if self.verbose:
			print("memuse %s: %.2f MB -> %.2f MB (%+.2f MB)" % (self.name,
				self.start/1e6, self.stop/1e6, self.diff/1e6))
