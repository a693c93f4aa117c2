"""Smoke test of the PyTorch/CUDA port (pixell_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written Legendre kernels from pixell_tpu_torch/csrc
with nvcc, then:

1. kernel phase: runs each of K1-K4 and its plain PyTorch version on the
   card, in float32 and float64, at the shapes the lmax-750 roundtrip gives
   it and at a small ragged shape. Both are held against the float64 plain
   version: a float64 kernel within 1e-11 (relative to the largest value),
   a float32 kernel within twice the float32 plain version's own error
   plus 1e-6.
2. slice phase: rand_alm -> alm2map -> map2alm -> alm2map through
   pixell_tpu_torch.curvedsky at lmax 750 on the 900x1800 Fejer-1 CAR map
   (float32 and float64) and at lmax 2000 on the 2160x4320 map (float32).
   The alm roundtrip must agree within 1e-4 (f32 at 750), 1e-10 (f64) and
   5e-4 (f32 at 2000), the band-limited map roundtrip within 1e-3, and a
   small transform on the card must match the CPU path. Every kernel must
   have been launched by the lmax-750 float32 roundtrip.
3. timing: 40 sequential lmax-750 float32 roundtrips (the work of
   bench.py) and 5 at lmax 2000, timed with CUDA events after warmup, and
   a profiler breakdown of 3 roundtrips at each lmax: device time by
   kernel and the device's busy share of the wall time.

It prints the card's name and power limit, one JSON line with each
kernel's launches, error and time beside its plain version, and as the
last line {"ok": true, "device": {...}}. Any failure raises, and the exit
code is then nonzero; without a CUDA device it exits with code 2.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "pixell_tpu_torch/csrc/legendre.cu"
# the TPU kernel each CUDA kernel replaces: its pallas_call site
REPLACES = {
	"sym_synthesis": "pixell_tpu/ops/sht_pallas.py:1755",
	"sym_analysis": "pixell_tpu/ops/sht_pallas.py:1928",
	"full_synthesis": "pixell_tpu/ops/sht_pallas.py:1668",
	"full_analysis": "pixell_tpu/ops/sht_pallas.py:2089",
}


def card_line():
	r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
		"--format=csv,noheader"], capture_output=True, text=True, check=True)
	return r.stdout.strip().splitlines()[0]


def relerr(x, ref):
	"""max |x - ref| / max |ref|, in double precision (complex-aware)."""
	wide = lambda a: a.to(torch.complex128 if a.is_complex() else torch.float64)
	return float((wide(x) - wide(ref)).abs().max()/wide(ref).abs().max())


def cuda_ms(fn, n):
	"""Mean time of fn() over n calls, with CUDA events, after one warmup."""
	fn()
	torch.cuda.synchronize()
	t0 = torch.cuda.Event(enable_timing=True)
	t1 = torch.cuda.Event(enable_timing=True)
	t0.record()
	for _ in range(n): fn()
	t1.record()
	torch.cuda.synchronize()
	return t0.elapsed_time(t1)/n


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_cases():
	"""(kernel, label, lmax, mmax, theta, dtype of the main path) for the
	lmax-750 roundtrip's shapes and a small ragged shape."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	lmax = 750
	th_syn = sht.ring_theta("F1", 900)     # the map's rings
	th_ana = sht.ring_theta("F1", 1512)    # after the exact theta upsample
	nn, ns = sht_cuda.polar_counts(th_syn, lmax)
	pol_syn = np.concatenate([th_syn[:nn], th_syn[len(th_syn)-ns:]])
	nn, ns = sht_cuda.polar_counts(th_ana, lmax)
	bulk_ana = th_ana[nn:len(th_ana)-ns]
	pol_ana = np.concatenate([th_ana[:nn], th_ana[len(th_ana)-ns:]])
	nh_ana = sht_cuda.detect_sym(bulk_ana)
	rng = np.random.default_rng(3)
	ragged = np.sort(rng.uniform(0.05, 3.1, 53))
	rag_sym = sht.ring_theta("F1", 53)[:27]
	pm = sht_cuda.POLAR_MMAX - 1
	f32, f64 = torch.float32, torch.float64
	return [
		("sym_synthesis", "lmax750", lmax, lmax, th_syn[:450], f32),
		("sym_analysis", "lmax750", lmax, lmax, bulk_ana[:nh_ana], f32),
		("full_synthesis", "lmax750-polar", lmax, pm, pol_syn, f64),
		("full_analysis", "lmax750-polar", lmax, pm, pol_ana, f64),
		("sym_synthesis", "ragged", 37, 29, rag_sym, f32),
		("sym_analysis", "ragged", 37, 29, rag_sym, f32),
		("full_synthesis", "ragged", 37, 29, ragged, f32),
		("full_analysis", "ragged", 37, 29, ragged, f32),
	]


def kernel_input(name, lmax, mmax, nt, seed):
	rng = np.random.default_rng(seed)
	nl, nm = lmax + 1, mmax + 1
	if name.endswith("synthesis"): shape = (nl, nm, 2)
	elif name == "sym_analysis": shape = (2, 2, nm, nt)
	else: shape = (2, nm, nt)
	return rng.standard_normal(shape)


def kernel_phase():
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	records = {}
	for i, (name, label, lmax, mmax, theta, main_dt) in enumerate(kernel_cases()):
		kern, plain = getattr(sht_cuda, name), sht_cuda.PLAIN[name]
		x = torch.from_numpy(kernel_input(name, lmax, mmax, len(theta), i)).to(dev)
		g64 = sht_cuda.geom(theta, mmax, torch.float64, dev)
		ref = plain(x, g64, lmax)
		torch.cuda.synchronize()
		out = {}
		for dt in (torch.float32, torch.float64):
			g = sht_cuda.geom(theta, mmax, dt, dev)
			xd = x.to(dt)
			k = kern(xd, g, lmax)
			torch.cuda.synchronize()   # a fault shows here, at its kernel
			if not bool(torch.isfinite(k).all()):
				raise RuntimeError("%s %s %s: non-finite output" % (name, label, dt))
			err = relerr(k, ref)
			if dt == torch.float64:
				bound, perr = 1e-11, 0.0
			else:
				perr = relerr(plain(xd, g, lmax), ref)
				bound = 2*perr + 1e-6
			ok = err <= bound
			print("kernel %-14s %-13s %s: rel err %.3e (plain %.3e, bound %.3e) %s"
				% (name, label, str(dt)[6:], err, perr, bound, "ok" if ok else "FAIL"))
			if not ok:
				raise RuntimeError("%s %s %s: kernel disagrees with its plain version"
					% (name, label, dt))
			out[dt] = (xd, g, k)
		if label.startswith("lmax750"):
			xd, g, k = out[main_dt]
			rec = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
				"replaces": REPLACES[name],
				"max_abs_err": float((k.double() - ref).abs().max()),
				"ms": cuda_ms(lambda: kern(xd, g, lmax), 20),
				"plain_ms": cuda_ms(lambda: plain(xd, g, lmax), 2),
				"shape": "lmax %d, nm %d, nt %d, %s" % (lmax, mmax + 1, len(theta),
					str(main_dt)[6:])}
			print("time   %-14s %s: kernel %.4f ms, plain %.4f ms" % (name, rec["shape"],
				rec["ms"], rec["plain_ms"]))
			records[name] = rec
	return records


# ---------------------------------------------------------------------------
# 2. the spin-0 roundtrip through the public API
# ---------------------------------------------------------------------------
def roundtrip(lmax, shape, dtype, alm_tol, device="cuda", seed=0):
	"""rand_alm -> alm2map -> map2alm -> alm2map on a full-sky Fejer-1 map.
	Returns (alm error, map error) relative to the largest value."""
	from pixell_tpu_torch import enmap, curvedsky
	cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	alm = curvedsky.rand_alm(np.ones(lmax + 1), lmax=lmax, seed=seed, dtype=cdt,
		device=device)
	m = curvedsky.alm2map(alm, enmap.zeros(gshape, wcs, dtype, device), spin=[0])
	alm2 = curvedsky.map2alm(m, lmax=lmax, spin=[0])
	m2 = curvedsky.alm2map(alm2, enmap.zeros(gshape, wcs, dtype, device), spin=[0])
	if device == "cuda": torch.cuda.synchronize()
	for name, x, want in [("map", m.data, gshape), ("alm", alm2, alm.shape),
			("map2", m2.data, gshape)]:
		if tuple(x.shape) != tuple(want) or not bool(torch.isfinite(x).all()):
			raise RuntimeError("%s: bad output %s %s" % (name, tuple(x.shape), x.dtype))
	ealm, emap = relerr(alm2, alm), relerr(m2.data, m.data)
	print("roundtrip lmax %d %s %s on %s: alm rel err %.3e (bound %.1e), "
		"band-limited map rel err %.3e (bound 1e-3)" % (lmax, shape, str(dtype)[6:],
		device, ealm, alm_tol, emap))
	if not (ealm <= alm_tol and emap < 1e-3):
		raise RuntimeError("roundtrip lmax %d %s outside its bounds" % (lmax, dtype))
	return m, alm2


def slice_phase():
	from pixell_tpu_torch.ops import sht_cuda
	for k in sht_cuda.LAUNCHES: sht_cuda.LAUNCHES[k] = 0
	roundtrip(750, (900, 1800), torch.float32, 1e-4)
	launches = dict(sht_cuda.LAUNCHES)
	print("launches in the lmax-750 f32 roundtrip:", launches)
	missing = [k for k, v in launches.items() if v == 0]
	if missing:
		raise RuntimeError("kernels not launched by the main path: %s" % missing)
	roundtrip(750, (900, 1800), torch.float64, 1e-10)
	roundtrip(2000, (2160, 4320), torch.float32, 5e-4)
	# a small transform on the card against the same transform on the CPU
	mc, ac = roundtrip(48, (60, 120), torch.float64, 1e-10, seed=1)
	mh, ah = roundtrip(48, (60, 120), torch.float64, 1e-10, device="cpu", seed=1)
	e = max(relerr(mc.data.cpu(), mh.data), relerr(ac.cpu(), ah))
	print("card vs cpu at lmax 48 f64: rel err %.3e (bound 1e-10)" % e)
	if not e <= 1e-10: raise RuntimeError("card and CPU paths disagree")
	return launches


# ---------------------------------------------------------------------------
# 3. timing
# ---------------------------------------------------------------------------
def roundtrip_step(lmax, shape):
	"""arr -> alm2map(map2alm(arr)) at lmax on the full-sky F1 map, f32."""
	from pixell_tpu_torch import enmap, curvedsky
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	ainfo = curvedsky.alm_info(lmax=lmax)
	def step(arr):
		alm = curvedsky.map2alm(enmap.ndmap(arr, wcs), lmax=lmax, spin=[0])
		return curvedsky.alm2map(alm, enmap.zeros(gshape, wcs, torch.float32, "cuda"),
			spin=[0], ainfo=ainfo).data
	rng = np.random.default_rng(0)
	arr = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32)).cuda()
	arr = step(step(arr))   # warmup; the result is band-limited
	torch.cuda.synchronize()
	return step, arr


def time_roundtrips(lmax, shape, nrep):
	"""nrep sequential roundtrips, timed with CUDA events (and the host
	clock) after warmup; checks the band-limited map comes back."""
	step, arr = roundtrip_step(lmax, shape)
	t0 = torch.cuda.Event(enable_timing=True)
	t1 = torch.cuda.Event(enable_timing=True)
	h0 = time.perf_counter()
	t0.record()
	x = arr
	for _ in range(nrep): x = step(x)
	t1.record()
	torch.cuda.synchronize()
	host = time.perf_counter() - h0
	ms = t0.elapsed_time(t1)
	rel = relerr(x, arr)
	print("timing: %d x lmax-%d f32 roundtrip = %.3f ms (%.4f ms each; host clock "
		"%.3f ms); drift after %d roundtrips %.3e" % (nrep, lmax, ms, ms/nrep, host*1e3,
		nrep, rel))
	if not rel < 1e-3: raise RuntimeError("timed roundtrips drifted: %g" % rel)
	return ms


def profile_roundtrips(lmax, shape, nrep=3):
	"""Device time by kernel over nrep roundtrips, and the device's busy
	share of the host wall time (the rest is the device waiting on the host)."""
	from torch.profiler import profile, ProfilerActivity
	step, arr = roundtrip_step(lmax, shape)
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		h0 = time.perf_counter()
		y = arr
		for _ in range(nrep): y = step(y)
		torch.cuda.synchronize()
		wall = time.perf_counter() - h0
	ka = prof.key_averages()
	key = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
		else "self_cuda_time_total"
	# device-side events only, as the profiler's own "Self CUDA time total"
	busy = sum(getattr(e, key) for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
		and not getattr(e, "is_user_annotation", False))/1e3
	print("profile: %d x lmax-%d f32 roundtrip: wall %.3f ms, device busy %.3f ms (%.1f %%)"
		% (nrep, lmax, wall*1e3, busy, 100*busy/(wall*1e3)))
	print(ka.table(sort_by=key, row_limit=14, max_name_column_width=56))


def main():
	if not torch.cuda.is_available():
		print("chip_smoke: no CUDA device", file=sys.stderr)
		return 2
	sys.path.insert(0, ROOT)
	from pixell_tpu_torch.ops import sht_cuda, _build
	print(card_line())
	print("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
		sys.version.split()[0]))
	torch.backends.cuda.matmul.allow_tf32 = False
	h0 = time.perf_counter()
	sht_cuda.library()
	print("kernel build + load: %.1f s" % (time.perf_counter() - h0))
	log = (_build.build_dir()/"build.log").read_text()
	for line in log.splitlines():
		if "registers" in line or "Compiling entry" in line: print("ptxas:", line.strip())
	records = kernel_phase()
	launches = slice_phase()
	time_roundtrips(750, (900, 1800), 40)
	time_roundtrips(2000, (2160, 4320), 5)
	profile_roundtrips(750, (900, 1800))
	profile_roundtrips(2000, (2160, 4320))
	for name, rec in records.items(): rec["launches"] = launches[name]
	print(card_line())
	print(json.dumps({"kernels": list(records.values())}))
	print(json.dumps({"ok": True, "device": {"platform": "gpu",
		"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
	return 0


if __name__ == "__main__":
	sys.exit(main())
