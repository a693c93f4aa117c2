"""Console entry points (counterpart of pixell_tpu/scripts.py):
benchmark-pixell-tpu-torch runs benchmark_main."""
from __future__ import annotations
import time
import numpy as np
import torch

# The install benchmark's size (pixell's: lmax 750 on the 12 arcmin full sky,
# 40 timed roundtrips); a test sets smaller values.
LMAX = 750
RES_ARCMIN = 12.0
NROUND = 40


def benchmark_main():
	"""pixell's install benchmark: NROUND x (map2alm + alm2map), spin 0, at
	lmax LMAX on the RES_ARCMIN Fejer-1 full sky (900 x 1800), from a
	standard normal map drawn by default_rng(0), after one roundtrip of
	warm-up (pixell_tpu.scripts.benchmark_main). float32 on the card,
	float64 on the CPU where there is no CUDA; the loop is timed with the
	card synchronized on either side. Prints the device and the time per
	roundtrip and returns the elapsed seconds."""
	from . import enmap, curvedsky, utils
	from .bench import device_sync
	dev = "cuda" if torch.cuda.is_available() else "cpu"
	dtype = torch.float32 if dev == "cuda" else torch.float64
	shape, wcs = enmap.fullsky_geometry(res=RES_ARCMIN*utils.arcmin, variant="fejer1")
	ainfo = curvedsky.alm_info(lmax=LMAX)
	def roundtrip(arr):
		alm = curvedsky.map2alm(enmap.ndmap(arr, wcs), lmax=LMAX, spin=[0])
		return curvedsky.alm2map(alm, enmap.zeros(shape, wcs, dtype, device=dev), spin=[0], ainfo=ainfo).data
	rng = np.random.default_rng(0)
	arr = torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
	arr = roundtrip(arr)
	device_sync()
	t0 = time.perf_counter()
	for i in range(NROUND):
		arr = roundtrip(arr)
	device_sync()
	elapsed = time.perf_counter() - t0
	name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
	print("Benchmarking SHTs on %s (%s)" % (name, str(dtype)[6:]))
	print("%d x (map2alm lmax=%d + alm2map) on %dx%d: %8.3f s  (%5.1f ms each)"
		% (NROUND, LMAX, shape[0], shape[1], elapsed, elapsed/NROUND*1000))
	return elapsed
