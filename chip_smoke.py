"""Smoke test of the PyTorch/CUDA port (pixell_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from pixell_tpu_torch/csrc with nvcc
(legendre.cu once per mode, blockleg.cu once per Legendre mode and
fma_peak.cu, all compilers started together) and prints each kernel's
registers and spills, then runs the phases below (all of them with no
arguments; --phases with a choice of k9,kernels,lstop,slice,adjoint,blocked,
timing runs those alone, for work on one phase, and gives no verdict; the
phase "variants", 6. below, runs only when named):

1. K9 phase: the FMA-peak kernel against its plain PyTorch chain on a small
   grid (the kernel rounds once per step, the chain twice: within
   3 * iters * eps of the largest value), then its FP32 and FP64 rates at
   full size beside the data-sheet peaks.
2. kernel phase: each of K1-K4 in each mode (scalar, deriv, spin1, spin2)
   and its plain PyTorch version on the card, in float32 and float64, at
   the shapes the lmax-750 roundtrip gives it (C = 4 coefficient columns
   for spin2, 2 otherwise) and at a small ragged shape. Both are held
   against the float64 plain version: a float64 kernel within 1e-11
   (scalar) or 1e-10 (the spin modes, whose 1/sin^2 terms cancel near the
   poles) relative to the largest value, a float32 kernel within twice the
   float32 plain version's own error plus 1e-6, over all entries and again
   over the entries the float32 main path keeps (not the near-pole rings
   that its float64 pass replaces), where that error is small. At the
   lmax-750 shapes it times the kernel (its device time in the profiler,
   the mean over the launches traced; CUDA events, marked, where the
   profiler traces fewer than half of them), the
   plain version, and the library yardstick: one torch.bmm over m with a
   precomputed mode-function table [nm, nfun*nt, nl], checked against the
   plain version (1e-4 in f32, 1e-10 in f64); and it computes each
   kernel's bound. K3 and K4 in the wigner mode (K7; spin 3, C = 4) run the
   same checks at the shapes the spin [0, 3] roundtrip gives them: the
   float32 bulk (751 m rows; 900 rings for synthesis, the 1512 upsampled
   rings less the near-pole ones for analysis) with the dead-tile table,
   which must mark dead tiles, and the float64 near-pole pass (128 m rows,
   46 / 78 rings).
   polar_analysis and polar_synthesis, K4's and K3's float64 near-pole
   passes redesigned (csrc/legendre.cu polar_analysis_kernel,
   polar_synthesis_kernel), in every mode on the input of K4's and K3's
   float64 near-pole cases, within the same float64 bounds; each one's time
   beside the K4 or K3 launch it replaced on the main path, both from this
   run ("replaced_ms"), and its bound and yardstick
   (those of K4 or K3 on that input). In every mode also on the 202
   near-pole rings of a 3929-ring Clenshaw-Curtis map at lmax 750, poles
   included, and 130 m rows with 6 columns: the ring-tile loop, the pole
   limits, a ragged m count and two launches into one output; and at the
   lmax-2000 roundtrips' near-pole shapes (the 2160-ring map's near-pole
   rings for synthesis, the upsampled map's for analysis; 128 m rows, or
   max(128, s + 1) in the wigner mode).
   Every float32 launch of K1-K4 runs their float32 bulk redesigned
   (csrc/legendre.cu bulk_synthesis_kernel, bulk_analysis_kernel; the
   float32 cases above), held to the float32 rule above in all five modes,
   also on a ragged shape of several ring tiles and partial-sum planes
   (lmax 300, 203 m rows, 333 rings, for the half-sky forms 333 northern
   rings). K1 at the lmax-750 shape takes the dead-tile table as on the
   main path, and its time without the table is printed beside.
   The float64 K1 and K2 at the float64 lmax-750 path's shapes (K1 on the
   map's 450 northern rings, K2 on the 756 northern upsampled rings; scalar
   and spin2) against the float64 plain version, with their times, bound
   over the FP64 peak, float64 torch.bmm yardstick and launches per
   float64 roundtrip (printed, "f64 row").
   lstop: the bulk kernels at the lmax-2000 float32 shapes (2001 m rows):
   K1 on the map's 1080 northern rings (scalar, spin2), K3 on its 2160
   rings (scalar, spin2, wigner), K4 on the two chunks of 2048 and 1906
   upsampled bulk rings that the main path gives it (the first in scalar,
   spin2 and wigner mode, the second in scalar and wigner), each launched
   with the dead-tile table and without: the table must mark dead tiles,
   the two results differ by at most 1e-9 (scalar) or 1e-7 (spin2, wigner)
   of the largest value, and both times are printed. Each launch with the
   table is held to the float32 rule above against the float64 plain
   version. For the main path's launches (K1 scalar and spin2, K3 wigner,
   K4 on the first chunk) the bound and the torch.bmm yardstick, taken
   over m in chunks of 64 rows (the whole mode table does not fit in
   memory) with the times summed.
3. slice phase, through pixell_tpu_torch.curvedsky, each path driven with
   the launch counts set to 0 just before it and read just after:
   rand_alm -> alm2map -> map2alm -> alm2map on full-sky Fejer-1 maps
   - spin 0 at lmax 750 (900x1800; f32 and f64) and lmax 2000 (2160x4320,
     f32): alm within 1e-4 / 1e-10 / 5e-4;
   - IQU, spin [0, 2], with a diagonal TQU spectrum, at lmax 750 (f32 and
     f64) and lmax 2000 (f32): alm within 5e-4 / 1e-10 / 2e-3;
   - spin [1] at lmax 750 (f32): alm within 5e-4;
   - spin [0, 3] on a 3-component map, the spin-3 block through the wigner
     mode of K3/K4, at lmax 750 (f32 and f64) and lmax 2000 (f32): alm
     within 5e-4 / 1e-10 / 2e-3, with the launches of every kernel by mode
     and dtype held against what the dispatch should give;
   every f32 path runs its near-pole rings through polar_synthesis (one
   launch per alm2map in its mode) and polar_analysis in float64, and K3
   and K4 in float64 never; its K1-K4 launches run the bulk kernels
   (sht_cuda.BULK_KERNELS), never another float32 kernel;
   every band-limited map roundtrip within 1e-3; deriv=True alm2map and
   map2alm at lmax 750 in f32 against the same on the card in f64 (1e-3);
   the wigner mode at spin 2 against the spin2 mode on the card at lmax 750
   in f64 (1e-10); and small transforms (spin 0, deriv, spin 1, spin 3;
   lmax 48, f64) on the card against the CPU (1e-10). Every kernel must have
   been launched, in its path's mode, by the lmax-750 f32 path of that mode.
4. blocked phase, the block-Legendre split (K8: blk_synthesis and
   blk_analysis, csrc/blockleg.cu; K3/K4's stop degrees and state handoff)
   at lmax = mmax = 2000, float32:
   - per mode (scalar and deriv and spin1 with C = 2, spin2 with C = 4), on
     the first 2048 bulk rings of the 4032 upsampled Fejer-1 rings: K3 and
     K4 with the split's stop degrees and the state handed over, and the
     block kernels resumed from that state, each against its plain version
     in float64 (within twice the float32 plain version's own error plus
     2e-6; the state compared unscaled); prefix plus suffix against K3/K4
     run to the end (0 < difference < 3e-5 scalar, 5e-5 deriv and spin1,
     2e-4 spin2, of the largest value; tiles without a suffix, and degrees
     below every handoff, bit-identical); the times of the block kernels,
     of the dumping K3/K4 and of K3/K4 run to the end, and the block
     kernels' bound over the FP32 peak, for blk_analysis (its products in
     3xTF32 on the tensor cores) also the tensor-core bound: the build's
     FP32 operations over the FP32 peak plus 3 x the products' FLOPs over
     495 TFLOP/s; the library yardstick: torch.bmm over m of K3's / K4's
     mode table masked to each entry's blocked suffix (TF32 off), in
     chunks of 64 m rows with the times summed, its first chunk held
     within 1e-4 of the float64 plain block kernel resumed from the
     float64 state; before all that, every blk_analysis_kernel
     instantiation's registers and spills (ptxas -v) and the count of
     tensor-core instructions (HMMA, HGMMA) in its SASS (cuobjdump -sass):
     a spill or a count of 0 fails;
   - through curvedsky under `with sht.blocked():`, each call beside the
     same call outside it (same bounds; CUDA-event times of both): map2alm
     of full-sky 2160x4320 maps, spin 0, IQU, spin 1 and deriv, with the
     alm roundtrip held to 5e-4 (spin 0) / 2e-3; alm2map, spin 0, IQU,
     spin 1 and deriv, onto the declination band -63..+23 degrees of that
     grid (rows 324:1356, 1032 rings, not south-symmetric). The block
     kernels must launch in each call's mode inside the context, not at all
     outside it, and not at lmax 750.
   adjoint (run after slice): alm2map_adjoint and map2alm_adjoint through
   pixell_tpu_torch.curvedsky at lmax 750 on the 900x1800 Fejer-1 map (spin
   0, IQU, spin [0, 3], deriv) and at lmax 2000 on 2160x4320 (spin 0, IQU),
   each path with the launch counts set to 0 just before and read just
   after: in float64 the dot-product identities <map2alm(m), a> =
   <m, map2alm_adjoint(a)> and <alm2map(a), m> = <a, alm2map_adjoint(m)>
   within 1e-10 relative (alm inner product sum Re Re + Im Im); in float32
   each output within the cell's forward guard of the float64 one (1e-4
   spin 0, 5e-4 the others at lmax 750; 5e-4, 2e-3 at lmax 2000), only the
   float32 bulk kernels and the float64 near-pole passes launched, and at
   lmax 2000 map2alm_adjoint's K3 float32 bulk on the 4032 upsampled rings
   with its stops (its peak device memory printed; that launch alone held
   to the float32 rule against the float64 plain version, with its time,
   bound and chunked torch.bmm yardstick, "K3 row"); then 10 x
   (alm2map_adjoint + map2alm_adjoint) at lmax 750, spin 0 and IQU, and one
   at lmax 2000, spin 0, timed with CUDA events beside the forward
   roundtrip of the same cell, each with its device busy share.
5. timing: sequential roundtrips timed with CUDA events after warmup (40
   spin-0, 10 IQU and 10 spin-[0, 3] at lmax 750; 5, 3 and 3 at lmax 2000)
   and a profiler breakdown of each: device time by kernel and the device's
   busy share of the wall time.
6. variants (only with --phases variants): the bulk kernels' design
   choices measured. legendre.cu is copied under build/variants/ once per
   edit of BULK_VARIANTS (two or four rings a thread everywhere in
   bulk_analysis_kernel, one or two in bulk_synthesis_kernel; the first group's
   test written gl0 == l8; north and mirror sums in the half-sky
   synthesis), each copy built (all started together) and its bulk
   kernels' registers and spills printed; at the main path's K1-K4 shapes
   each build's analysis result must lie within 1e-6 of the committed
   build's and its synthesis result within the float32 rule above (on the
   entries the main path keeps), and its device time is printed beside the
   committed build's. Run it alone: late in a long process the profiler
   drops device events, and the times fall back to CUDA events.

It prints the card's name and power limit, one JSON line with each
kernel's launches, error, time, bound and yardstick, and as the last line
{"ok": true, "device": {...}}. Any failure raises, and the exit code is then
nonzero; without a CUDA device it exits with code 2.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LEGENDRE_SOURCE = "pixell_tpu_torch/csrc/legendre.cu"
BLOCKLEG_SOURCE = "pixell_tpu_torch/csrc/blockleg.cu"
FMA_SOURCE = "pixell_tpu_torch/csrc/fma_peak.cu"
# the TPU kernel each CUDA kernel replaces: its pallas_call site
REPLACES = {
	"sym_synthesis": "pixell_tpu/ops/sht_pallas.py:1755",
	"sym_analysis": "pixell_tpu/ops/sht_pallas.py:1928",
	"full_synthesis": "pixell_tpu/ops/sht_pallas.py:1668",
	"full_analysis": "pixell_tpu/ops/sht_pallas.py:2089",
	# K4's and K3's float64 near-pole passes, redesigned
	"polar_analysis": "pixell_tpu/ops/sht_pallas.py:2089",
	"polar_synthesis": "pixell_tpu/ops/sht_pallas.py:1668",
	"fma_peak": "scripts/vpu_peak.py:58",
	# the scalar and the stream kernels of the block-Legendre split
	"blk_synthesis": ("pixell_tpu/ops/sht_pallas.py:997", "pixell_tpu/ops/sht_pallas.py:1145"),
	"blk_analysis": ("pixell_tpu/ops/sht_pallas.py:1319", "pixell_tpu/ops/sht_pallas.py:1457"),
}
MODES = ("scalar", "deriv", "spin1", "spin2", "wigner")   # in the build's order
WIGNER_SPIN = 3   # the spin the wigner mode is driven with
# NVIDIA H100 SXM data sheet: FP32 and FP64 outside the tensor cores, HBM3;
# dense TF32 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12


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


def _device_key(ka):
	return "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
		else "self_cuda_time_total"


def kernel_device_ms(fn, n, name, tries=4):
	"""(ms, launches traced): the device time of one launch of the kernel
	whose name matches the regular expression name, from the profiler over
	n calls of fn (each launching it once) after one warmup: the kernel's
	own time, without the gaps where the card waits for the host between
	launches. It is the mean
	over the launches the trace holds, since the profiler has been seen to
	drop a device event of a session (one of 20). Small torch operations
	open and close each session. A trace with fewer than half the launches
	is taken again; after tries such traces, returns None."""
	from torch.profiler import profile, ProfilerActivity
	fn()
	torch.cuda.synchronize()
	for _ in range(tries):
		with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
			torch.ones(1, device="cuda").add_(1)
			torch.cuda.synchronize()
			for _ in range(n): fn()
			torch.ones(1, device="cuda").add_(1)
			torch.cuda.synchronize()
		ka = prof.key_averages()
		events = [e for e in ka if re.search(name, e.key)]
		count = sum(e.count for e in events)
		if count > n:
			raise RuntimeError("profiler: %d launches of %s for %d calls of one" % (count, name, n))
		if 2*count >= n:
			return sum(getattr(e, _device_key(ka)) for e in events)/1e3/count, count
		print("profiler: %d launches of %s traced for %d calls; tracing again" % (count, name, n))
	return None


def kernel_ms(fn, n, name):
	"""(kernel ms, how it was timed): the profiler's device time, or where
	the profiler gives no usable trace, or a time above the CUDA events
	around n calls (which include the host's gaps between launches and so
	bound it from above), the time of those events."""
	ev = cuda_ms(fn, n)
	r = kernel_device_ms(fn, n, name)
	if r is None: return ev, "cuda events"
	if r[0] > ev: return ev, "cuda events; the profiler's %.4f ms exceeded them" % r[0]
	return r[0], "profiler, %d of %d launches traced" % (r[1], n)


def kernel_pattern(name, dtype=torch.float32):
	"""The regular expression that picks the CUDA kernel the wrapper name
	(sym_analysis, full_synthesis, ...) launches in dtype out of the
	profiler's kernel names, mangled or not: the float32 launches run
	bulk_analysis_kernel or bulk_synthesis_kernel, the float64 ones
	analysis_kernel or synthesis_kernel, not the bulk_, polar_ or blk_
	kernels of the same stem."""
	stem = name.split("_")[1]
	if dtype == torch.float32: return "bulk_%s_kernel" % stem
	return r"(?<![A-Za-z_])%s_kernel" % stem


def bound(ops, nbytes, dtype):
	"""(least time in ms, what bounds it): operations over the data-sheet
	peak for dtype, or bytes over the memory rate, whichever is larger."""
	t_ops, t_bytes = ops/PEAK_FLOPS[dtype], nbytes/PEAK_BYTES
	return 1e3*max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def print_build_summary(log, only=None):
	"""One line per compiled kernel from the build log's ptxas -v output:
	object, kernel, registers and spill bytes; with only, a regular
	expression, the kernels whose printed name it matches alone. Returns
	those lines' (object, kernel, registers, spill bytes)."""
	obj, entry, spill = "?", None, None
	worst, spilled, rows = 0, {}, []
	for line in log.splitlines():
		m = re.search(r"-DLEGENDRE_MODE=(\d)", line)
		if line.startswith(("nvcc", "/")) and " -c " in line:
			src = os.path.basename(line.split()[-1])
			obj = ("%s.%s" % (src.split(".")[0], MODES[int(m.group(1))])) if m else src
		m = re.search(r"Compiling entry function '([^']+)'", line)
		if m:
			k = re.search(r"(synthesis|analysis)_kernelI([fd])Li(\d+)ELb([01])", m.group(1))
			f = re.search(r"fma_peak_kernelI([fd])", m.group(1))
			b = re.search(r"blk_(synthesis|analysis)_kernelILi(\d+)E", m.group(1))
			p = re.search(r"polar_(analysis|synthesis)_kernelILi(\d+)E", m.group(1))
			u = re.search(r"bulk_(analysis|synthesis)_kernelILi(\d+)ELb([01])ELi(\d+)ELb([01])ELb([01])E",
				m.group(1))
			entry = ("%s<%s,C=%s,%s>" % (k.group(1), k.group(2), k.group(3),
				"sym" if k.group(4) == "1" else "full")) if k else \
				("fma_peak<%s>" % f.group(1) if f else
				("blk_%s<C=%s>" % b.groups() if b else
				("polar_%s<d,C=%s>" % p.groups() if p else
				("bulk_%s<C=%s,%s,R=%s%s%s>" % (u.group(1), u.group(2), "sym" if u.group(3) == "1" else
				"full", u.group(4), ",stops" if u.group(5) == "1" else "",
				",dump" if u.group(6) == "1" else "") if u else m.group(1)[:60]))))
		m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
		if m: spill = int(m.group(1)) + int(m.group(2))
		m = re.search(r"Used (\d+) registers", line)
		if m and entry is not None and (only is None or re.search(only, entry)):
			print("ptxas: %-16s %-36s %3s registers, %d bytes spilled" % (obj, entry,
				m.group(1), spill or 0))
			rows.append((obj, entry, int(m.group(1)), spill or 0))
			worst = max(worst, spill or 0)
			n, k = spilled.get(obj.split(".")[0], (0, 0))
			spilled[obj.split(".")[0]] = (n + 1, k + bool(spill))
			entry = None
	print("ptxas: largest spill of any kernel: %d bytes; kernels that spill, by source: %s" % (
		worst, ", ".join("%s %d of %d" % (src, k, n) for src, (n, k) in sorted(spilled.items()))))
	return rows


# ---------------------------------------------------------------------------
# 1. K9: the FMA peak
# ---------------------------------------------------------------------------
def fma_phase():
	from pixell_tpu_torch.ops import fma_peak as fp
	dev = torch.device("cuda")
	per_block = fp.library().pt_fma_peak_block_elems()
	fp.LAUNCHES["fma_peak"] = 0
	c, d = 0.999, 1e-3        # contracting chain towards d/(1-c) = 1
	rng = np.random.default_rng(9)
	for dt, eps in ((torch.float32, 2.0**-24), (torch.float64, 2.0**-53)):
		iters = 64
		x = torch.from_numpy(rng.uniform(0.5, 1.5, 3*per_block + 17)).to(dev, dt)
		k, p = fp.fma_peak(x, c, d, iters), fp.plain(x, c, d, iters)
		torch.cuda.synchronize()
		err = float((k.double() - p.double()).abs().max())
		tol = 3*iters*eps*float(p.abs().max())
		print("K9 fma_peak %s small grid: max abs diff to the plain chain %.3e (bound %.3e) %s"
			% (str(dt)[6:], err, tol, "ok" if err <= tol else "FAIL"))
		if not err <= tol: raise RuntimeError("fma_peak disagrees with its plain chain")
	records = []
	n, iters = 132*16*per_block, 8192     # 16 blocks per SM
	for dt in (torch.float32, torch.float64):
		x = torch.from_numpy(rng.uniform(0.5, 1.5, n)).to(dev, dt)
		ms, how = kernel_ms(lambda: fp.fma_peak(x, c, d, iters), 5, "fma_peak_kernel")
		plain_ms = cuda_ms(lambda: fp.plain(x, c, d, iters), 1)
		ops = fp.operations(x, iters)
		b_ms, b_by = bound(ops, 2*x.numel()*x.element_size(), dt)
		err = float((fp.fma_peak(x, c, d, 64).double() - fp.plain(x, c, d, 64).double()).abs().max())
		rate = ops/ms/1e9
		print("K9 fma_peak %s rate: %.2f TFLOP/s measured (%.1f TFLOP/s data-sheet peak; "
			"%.4f ms for %.3e operations; plain chain %.2f ms)" % (str(dt)[6:], rate,
			PEAK_FLOPS[dt]/1e12, ms, ops, plain_ms))
		records.append({"name": "fma_peak[%s]" % str(dt)[6:], "route": "cuda",
			"source": FMA_SOURCE, "replaces": REPLACES["fma_peak"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
			"bound_by": b_by, "library_ms": None, "tflops": rate, "ms_from": how,
			"shape": "n %d, iters %d, %s" % (n, iters, str(dt)[6:])})
	# this phase's own launches, for the record; "launches" is the main path's
	for r in records: r["phase_launches"] = fp.LAUNCHES["fma_peak"]
	print("K9 fma_peak launches in this phase: %d" % fp.LAUNCHES["fma_peak"])
	return records


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_cases(mode):
	"""(kernel, label, lmax, mmax, theta, dtype of the main path) for the
	lmax-750 roundtrip's shapes and a small ragged shape, in mode."""
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
	# several ring tiles and partial-sum planes, nm not a multiple of the m
	# tile, nt not of R x 32, every ring in the bulk (theta > POLAR_AMP/300);
	# for the half-sky forms 333 northern rings
	tiles_full = np.sort(rng.uniform(0.25, np.pi - 0.25, 333))
	tiles_sym = sht.ring_theta("F1", 900)[60:393]
	pm = sht_cuda.POLAR_MMAX - 1
	f32, f64 = torch.float32, torch.float64
	if mode == "wigner":   # K3/K4 only: the float32 bulk and the near-pole pass
		pm = max(sht_cuda.POLAR_MMAX, WIGNER_SPIN + 1) - 1
		return [
			("full_synthesis", "lmax750-bulk", lmax, lmax, th_syn, f32),
			("full_analysis", "lmax750-bulk", lmax, lmax, bulk_ana, f32),
			("full_synthesis", "lmax750-polar", lmax, pm, pol_syn, f64),
			("full_analysis", "lmax750-polar", lmax, pm, pol_ana, f64),
			("full_synthesis", "ragged", 37, 29, ragged, f32),
			("full_analysis", "ragged", 37, 29, ragged, f32),
			("full_synthesis", "ragged-tiles", 300, 202, tiles_full, f32),
			("full_analysis", "ragged-tiles", 300, 202, tiles_full, f32),
		]
	return [
		("sym_synthesis", "lmax750", lmax, lmax, th_syn[:450], f32),
		("sym_analysis", "lmax750", lmax, lmax, bulk_ana[:nh_ana], f32),
		("full_synthesis", "lmax750-polar", lmax, pm, pol_syn, f64),
		("full_analysis", "lmax750-polar", lmax, pm, pol_ana, f64),
		("sym_synthesis", "ragged", 37, 29, rag_sym, f32),
		("sym_analysis", "ragged", 37, 29, rag_sym, f32),
		("full_synthesis", "ragged", 37, 29, ragged, f32),
		("full_analysis", "ragged", 37, 29, ragged, f32),
		("sym_synthesis", "ragged-tiles", 300, 202, tiles_sym, f32),
		("sym_analysis", "ragged-tiles", 300, 202, tiles_sym, f32),
		("full_synthesis", "ragged-tiles", 300, 202, tiles_full, f32),
		("full_analysis", "ragged-tiles", 300, 202, tiles_full, f32),
	]


def ncoef(mode):
	return 4 if mode in ("spin2", "wigner") else 2


def mode_spin(mode):
	"""The spin a geometry is prepared with: the wigner mode's, else None."""
	return WIGNER_SPIN if mode == "wigner" else None


def kernel_input(name, mode, lmax, mmax, nt, seed):
	"""Random input of kernel name in mode: independent north and south
	values, so a wrong hemisphere sign cannot cancel."""
	from pixell_tpu_torch.ops.sht_core import NFUN
	rng = np.random.default_rng(seed)
	nl, nm, nf, C = lmax + 1, mmax + 1, NFUN[mode], ncoef(mode)
	if name.endswith("synthesis"): shape = (nl, nm, C)
	elif name == "sym_analysis": shape = (nf, C, 2, nm, nt)
	else: shape = (nf, C, nm, nt)
	return rng.standard_normal(shape)


# operations per (l, m, theta) triple of the kernels' own arithmetic (an FMA
# counts 2): the recurrence step and its unscaling, the mode functions
# (with lambda_{l-1}'s unscaling), and per coefficient column the
# accumulation: a multiply-add per function for synthesis (the half-sky
# kernel's mirror ring too: its even-l and odd-l sums meet once per (m,
# ring), O(nm nt), not counted), a multiply-add per function and one
# reduction add for analysis. The wigner mode steps a second branch
# with the offset's multiply-add on both (7 + 2*2) and combines the two
# into w and x (5). With dead-tile stops, only the triples of live
# blocks count: the others are not computed.
STEP_OPS = 7
MODE_OPS = {"scalar": 0, "deriv": 7, "spin1": 12, "spin2": 25, "wigner": 16}


def kernel_ops(name, mode, lmax, mmax, nt, C, dead=None):
	from pixell_tpu_torch.ops import sht_cuda
	from pixell_tpu_torch.ops.sht_core import NFUN
	nf = NFUN[mode]
	rings = np.full(mmax + 1, nt) if dead is None else \
		sht_cuda.live_mask(dead, mmax + 1, nt).sum(1).cpu().numpy()
	first = np.maximum(np.arange(mmax + 1), mode_spin(mode) or 0)   # each row's seed degree
	triples = int((rings*np.maximum(lmax + 1 - first, 0)).sum())
	if name.endswith("synthesis"):
		acc = 2*C*nf
	else:
		acc = C*(2*nf + 1)
	return triples*(STEP_OPS + MODE_OPS[mode] + acc)


def kernel_bytes(name, mode, lmax, mmax, nt, C, esize):
	"""Each input read once and each output written once: the alm or ring
	data, the coefficient and degree tables, the ring rows and seeds."""
	from pixell_tpu_torch.ops.sht_core import NFUN
	nl, nm, nf = lmax + 1, mmax + 1, NFUN[mode]
	planes = 2 if name.startswith("sym") else 1
	alm = nl*nm*C*esize
	rings = nf*C*planes*nm*nt*esize
	legendre = mode not in ("scalar", "wigner")   # the modes with degree norms and ring rows
	tables = (2 if mode == "scalar" else 3)*nl*nm*esize + (2*nl*esize if legendre else 0)
	geom = (2 + (4 if legendre else 0))*nt*esize \
		+ (2 if mode == "wigner" else 1)*nm*nt*(esize + 4)
	return alm + rings + tables + geom


def mode_table(theta, mmax, lmax, mode, dtype, device):
	"""u_f(l, m, theta_t) as [nm, nfun*nt, nl] in dtype, from the float64
	plain recurrence and mode functions (sht_core.mode_values)."""
	from pixell_tpu_torch.ops import sht_core, sht_cuda
	g = sht_cuda.geom(theta, mmax, torch.float64, device, mode_spin(mode))
	nf = sht_core.NFUN[mode]
	T = torch.zeros((g.nm, nf, g.nt, lmax + 1), dtype=dtype, device=device)
	for l, us in sht_core.mode_values(mode, g, lmax):
		for f, u in enumerate(us):
			T[:, f, :, l] = u
	return T.view(g.nm, nf*g.nt, lmax + 1)


def library_call(name, mode, x, theta, mmax, lmax):
	"""(T, B, to_kernel_layout): torch.bmm(T, B), one batched product over m,
	computes the kernel's function from a precomputed mode-function table T,
	and the map of its result onto the kernel's output
	(library_operand). Built outside the timing."""
	T = mode_table(theta, mmax, lmax, mode, x.dtype, x.device)  # [nm, nf*nt, nl]
	B, layout = library_operand(name, mode, x, len(theta))
	return (T if name.endswith("synthesis") else T.transpose(1, 2)), B, layout


def library_operand(name, mode, x, nt):
	"""(B, to_kernel_layout): the operand of the library yardstick's product
	over the m rows of the kernel input x, and the map of the product onto
	the kernel's output. Half-sky synthesis multiplies by [A, (-1)^(l+m) A]
	for both hemispheres (the mirror plane's PSIGN[f] is applied outside the
	product); half-sky analysis by the planes each function reads at even
	and at odd l+m (the choice per (l, m) is made outside)."""
	from pixell_tpu_torch.ops import sht_cuda
	from pixell_tpu_torch.ops.sht_core import NFUN
	nf = NFUN[mode]
	psign = sht_cuda._psign(mode, x.dtype, x.device) if name.startswith("sym") else None
	if name.endswith("synthesis"):
		nl, nm = x.shape[:2]
		C = x.shape[-1]
		if name.startswith("sym"):
			sgn = sht_cuda._parity(nl, nm, x.dtype, x.device)[..., None]
			B = torch.cat([x, x*sgn], -1).permute(1, 0, 2).contiguous()   # [nm, nl, 2C]
			def layout(Y):
				Y = Y.view(nm, nf, nt, 2, C).permute(1, 4, 3, 0, 2)        # [nf, C, 2, nm, nt]
				return torch.stack([Y[:, :, 0], Y[:, :, 1]*psign[:, None, None, None]], 2)
		else:
			B = x.permute(1, 0, 2).contiguous()                          # [nm, nl, C]
			layout = lambda Y: Y.view(nm, nf, nt, C).permute(1, 3, 0, 2)  # [nf, C, nm, nt]
		return B, layout
	C, nm = x.shape[1], x.shape[-2]
	if name.startswith("sym"):
		F = sht_cuda._even_odd(x, mode)                                  # [nf, 2C, nm, nt]
		def layout(Y):
			Y = Y.transpose(0, 1)                                          # [nl, nm, 2C]
			lodd = sht_cuda._parity(Y.shape[0], nm, torch.int64, x.device)[..., None] < 0
			return torch.where(lodd, Y[..., C:], Y[..., :C])
	else:
		F = x
		layout = lambda Y: Y.transpose(0, 1)                             # [nl, nm, C]
	B = F.permute(2, 0, 3, 1).reshape(nm, nf*nt, F.shape[1]).contiguous()
	return B, layout


def library_ms(name, mode, x, theta, mmax, lmax, ref):
	"""(ms, rel err against ref) of the library yardstick; TF32 is off."""
	T, B, layout = library_call(name, mode, x, theta, mmax, lmax)
	fn = lambda: torch.bmm(T, B)
	err = relerr(layout(fn()), ref)
	ms = cuda_ms(fn, 20)
	del T, B
	torch.cuda.empty_cache()
	return ms, err


def f32_kept(theta, lmax, mmax, device, s=None):
	"""[nm, nt] mask of the (m, ring) entries that the float32 main path
	keeps from a float32 kernel on the rings theta: all but the near-pole
	rings for m < POLAR_MMAX (in the wigner mode at spin s, m <
	max(POLAR_MMAX, s + 1)), which the float64 pass overwrites (synthesis)
	or which never reach a float32 kernel (analysis); nothing where every
	ring is near a pole, since such a ring set runs wholly in float64."""
	from pixell_tpu_torch.ops import sht_cuda
	th = np.asarray(theta, np.float64)
	tcut = sht_cuda.POLAR_AMP/max(lmax, 1)
	polar = torch.from_numpy((th < tcut) | (th > np.pi - tcut)).to(device)
	if bool(polar.all()): return torch.zeros((mmax + 1, len(th)), dtype=torch.bool, device=device)
	mp = sht_cuda.POLAR_MMAX if s is None else max(sht_cuda.POLAR_MMAX, s + 1)
	high_m = torch.arange(mmax + 1, device=device)[:, None] >= mp
	return high_m | ~polar[None, :]


def kept_err(name, k, p, ref, kept):
	"""(kernel, plain) f32 rel errs on the entries the main path keeps, or
	None where it keeps none. Synthesis masks its output rings; analysis
	reads its input's, so it is either all kept or not run in float32."""
	if not bool(kept.any()): return None
	if name.endswith("synthesis"):
		return relerr(k[..., kept], ref[..., kept]), relerr(p[..., kept], ref[..., kept])
	if not bool(kept.all()):
		raise RuntimeError("%s: an analysis ring set only partly near the poles" % name)
	return relerr(k, ref), relerr(p, ref)


def kernel_phase():
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	records = {}
	for mode in MODES:
		s = mode_spin(mode)
		for i, (name, label, lmax, mmax, theta, main_dt) in enumerate(kernel_cases(mode)):
			kern, plain = getattr(sht_cuda, name), sht_cuda.PLAIN[name]
			C = ncoef(mode)
			x = torch.from_numpy(kernel_input(name, mode, lmax, mmax, len(theta), i)).to(dev)
			g64 = sht_cuda.geom(theta, mmax, torch.float64, dev, s)
			ref = plain(x, g64, lmax, mode)
			torch.cuda.synchronize()
			# the float32 launches of K1, K3 and K4 at the main path's shapes carry
			# the dead-tile table, as on the main path
			dead = None
			if main_dt == torch.float32 and label.startswith("lmax750") and name != "sym_analysis":
				dead = sht_cuda.dead_stops(theta, lmax, mmax, s or 0, dev)
				if dead is None:
					raise RuntimeError("%s %s %s: no dead tile in the table" % (name, mode, label))
				print("dead tiles %s %s %s: %d of %d blocks" % (name, mode, label, int((dead == 0).sum()),
					dead.numel()))
			out = {}
			for dt in (torch.float32, torch.float64):
				g = sht_cuda.geom(theta, mmax, dt, dev, s)
				xd = x.to(dt)
				args = (xd, g, lmax, mode) + ((dead,) if dt == torch.float32 and dead is not None else ())
				k = kern(*args)
				torch.cuda.synchronize()   # a fault shows here, at its kernel
				if not bool(torch.isfinite(k).all()):
					raise RuntimeError("%s %s %s %s: non-finite output" % (name, mode, label, dt))
				if tuple(k.shape) != tuple(ref.shape):
					raise RuntimeError("%s %s: shape %s, expected %s" % (name, mode,
						tuple(k.shape), tuple(ref.shape)))
				err = relerr(k, ref)
				kept = ""
				if dt == torch.float64:
					tol, perr = (1e-11 if mode == "scalar" else 1e-10), 0.0
					ok = err <= tol
				else:
					p = plain(*args)
					perr = relerr(p, ref)
					tol = 2*perr + 1e-6
					ok = err <= tol
					# the same rule on the entries the f32 path keeps, where the
					# plain version's own error is small
					ke = kept_err(name, k, p, ref, f32_kept(theta, lmax, mmax, dev, s))
					if ke is None:
						kept = "; kept entries: none, the main path runs these in float64"
					else:
						ktol = 2*ke[1] + 1e-6
						ok = ok and ke[0] <= ktol
						kept = "; kept entries: rel err %.3e (plain %.3e, bound %.3e)" % (
							ke[0], ke[1], ktol)
				print("kernel %-14s %-6s %-13s %s: rel err %.3e (plain %.3e, bound %.3e)%s %s"
					% (name, mode, label, str(dt)[6:], err, perr, tol, kept, "ok" if ok else "FAIL"))
				if not ok:
					raise RuntimeError("%s %s %s %s: kernel disagrees with its plain version"
						% (name, mode, label, dt))
				out[dt] = (args, k)
			if not label.startswith("lmax750"): continue
			args, k = out[main_dt]
			xd = args[0]
			nt = len(theta)
			b_ms, b_by = bound(kernel_ops(name, mode, lmax, mmax, nt, C, dead),
				kernel_bytes(name, mode, lmax, mmax, nt, C, xd.element_size()), main_dt)
			run = lambda: kern(*args)
			ms, how = kernel_ms(run, 20, kernel_pattern(name, main_dt))
			lib_ms, lib_err = library_ms(name, mode, xd, theta, mmax, lmax, ref)
			lib_tol = 1e-4 if main_dt == torch.float32 else 1e-10
			print("library %-14s %-6s: torch.bmm over the mode-function table %.4f ms, "
				"rel err %.3e (bound %.0e)" % (name, mode, lib_ms, lib_err, lib_tol))
			if not lib_err <= lib_tol:
				raise RuntimeError("%s %s: the library yardstick computes another function"
					% (name, mode))
			tag = mode if mode != "wigner" else "wigner, %s" % (
				"f32 bulk" if label.endswith("bulk") else "f64 near-pole")
			kname = sht_cuda.BULK_KERNELS[name] if main_dt == torch.float32 else name
			rec = {"name": "%s[%s]" % (kname, tag), "route": "cuda", "source": LEGENDRE_SOURCE,
				"replaces": REPLACES[name], "mode": mode,
				"max_abs_err": float((k.double() - ref).abs().max()),
				"ms": ms, "ms_from": how, "call_ms": cuda_ms(run, 20),
				"plain_ms": timed_once(lambda: plain(*args))[1],
				"bound_ms": b_ms, "bound_by": b_by,
				"library_ms": lib_ms, "library_rel_err": lib_err,
				"shape": "lmax %d, nm %d, nt %d, C %d, %s%s" % (lmax, mmax + 1, nt, C,
					str(main_dt)[6:], "" if dead is None else ", dead-tile table")}
			if dead is not None:   # the same launch without the table
				rec["ms_without_dead_table"] = kernel_ms(lambda: kern(*args[:4]), 20,
					kernel_pattern(name, main_dt))[0]
			print("time   %-14s %-6s %s: kernel %.4f ms (%s; wrapper call %.4f ms%s), plain %.2f ms, "
				"bound %.4f ms (%s, %.1f %% of it reached), torch.bmm %.4f ms" % (name, mode,
				rec["shape"], rec["ms"], how, rec["call_ms"], "" if dead is None else
				"; without the table %.4f ms" % rec["ms_without_dead_table"], rec["plain_ms"], b_ms,
				b_by, 100*b_ms/rec["ms"], lib_ms))
			records[(kname, mode, str(main_dt)[6:])] = rec
			if label == "lmax750-polar":
				pname = "polar_" + name.split("_")[1]
				records[(pname, mode, "float64")] = polar_record(pname, mode, args, k, ref, rec)
		for pname in sht_cuda.POLAR_KERNELS: polar_shapes(pname, mode)
	f64_sym_rows()
	return records


def f64_sym_rows():
	"""K1 and K2 in float64 at the shapes the float64 lmax-750 roundtrip
	gives them (no near-pole split in float64): K1 (synthesis_kernel<double,
	C,true>) on the map's 450 northern rings and K2 (analysis_kernel<double,
	C,true>) on the 756 northern rings of the 1512 upsampled ones, nm 751,
	scalar (C = 2) and spin2 (C = 4). Each against the float64 plain version
	(1e-11 / 1e-10 of the largest value), its time (profiler), the plain
	version's, the bound over the FP64 peak and the float64 torch.bmm
	yardstick, and its launches in one float64 roundtrip of the mode's path
	(spin 0; IQU)."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	dev, f64, lmax = torch.device("cuda"), torch.float64, 750
	counts = {}
	for mode, spin in (("scalar", (0,)), ("spin2", (0, 2))):
		sht_cuda.reset_launches()
		roundtrip(lmax, (900, 1800), f64, 1e-10, spin=spin, seed=7)
		counts[mode] = dict(sht_cuda.LAUNCHES_BY_DTYPE)
	rings = {"sym_synthesis": sht.ring_theta("F1", 900)[:450], "sym_analysis": sht.ring_theta("F1", 1512)[:756]}
	for mode in ("scalar", "spin2"):
		for i, (name, theta) in enumerate(rings.items()):
			kern, plain, C, nt = getattr(sht_cuda, name), sht_cuda.PLAIN[name], ncoef(mode), len(theta)
			x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt, 80 + i)).to(dev)
			g = sht_cuda.geom(theta, lmax, f64, dev)
			ref, plain_ms = timed_once(lambda: plain(x, g, lmax, mode))
			k = kern(x, g, lmax, mode)
			torch.cuda.synchronize()
			err, tol = relerr(k, ref), (1e-11 if mode == "scalar" else 1e-10)
			if not (err <= tol and bool(torch.isfinite(k).all())):
				raise RuntimeError("%s %s float64 at lmax 750: rel err %.3e against the plain version"
					% (name, mode, err))
			ms, how = kernel_ms(lambda: kern(x, g, lmax, mode), 20, kernel_pattern(name, f64))
			b_ms, b_by = bound(kernel_ops(name, mode, lmax, lmax, nt, C),
				kernel_bytes(name, mode, lmax, lmax, nt, C, 8), f64)
			lib_ms, lib_err = library_ms(name, mode, x, theta, lmax, lmax, ref)
			if not lib_err <= 1e-10:
				raise RuntimeError("%s %s: the float64 yardstick computes another function" % (name, mode))
			print("f64 row %-13s %-6s lmax %d, nm %d, nt %d, C %d: kernel %s_kernel<double> %.4f ms (%s), "
				"rel err %.3e (bound %.0e), plain %.2f ms, bound %.4f ms (%s, %.1f %% of it reached), "
				"torch.bmm f64 %.4f ms (rel err %.3e); launches per float64 roundtrip %d" % (name, mode,
				lmax, lmax + 1, nt, C, name.split("_")[1], ms, how, err, tol, plain_ms, b_ms, b_by,
				100*b_ms/ms, lib_ms, lib_err, counts[mode][(name, mode, "float64")]))


def polar_check(pname, mode, label, kp, ref):
	"""Hold a polar_analysis or polar_synthesis result against the float64
	plain version: 1e-11 (scalar) or 1e-10 (the other modes) of the largest
	value."""
	if not bool(torch.isfinite(kp).all()) or tuple(kp.shape) != tuple(ref.shape):
		raise RuntimeError("%s %s %s: bad output %s" % (pname, mode, label, tuple(kp.shape)))
	err, tol = relerr(kp, ref), (1e-11 if mode == "scalar" else 1e-10)
	print("kernel %-15s %-6s %-13s float64: rel err %.3e (bound %.0e) %s" % (pname, mode, label,
		err, tol, "ok" if err <= tol else "FAIL"))
	if not err <= tol:
		raise RuntimeError("%s %s %s: kernel disagrees with its plain version"
			% (pname, mode, label))


def polar_record(pname, mode, args, k_old, ref, old):
	"""pname (polar_analysis or polar_synthesis) on the input and geometry
	of K4's or K3's float64 near-pole record old (the lmax-750 shape):
	parity, time, bound, and the time of the K4 or K3 launch it replaces on
	the main path, both measured in this run. The plain
	version and the torch.bmm yardstick compute the same function on the
	same input as old's, and were timed there."""
	from pixell_tpu_torch.ops import sht_cuda
	kern = getattr(sht_cuda, pname)
	kp = kern(*args)
	torch.cuda.synchronize()
	polar_check(pname, mode, "lmax750-polar", kp, ref)
	run = lambda: kern(*args)
	ms, how = kernel_ms(run, 20, pname + "_kernel")
	syn = pname == "polar_synthesis"
	k34 = "K3" if syn else "K4"
	rec = dict(old, name="%s[%s]" % (pname, mode if mode != "wigner" else "wigner, f64 near-pole"),
		replaces=REPLACES[pname], max_abs_err=float((kp - ref).abs().max()), ms=ms, ms_from=how,
		call_ms=cuda_ms(run, 20), replaced_ms=old["ms"],
		replaced_kernel="%s (%s_kernel<double,C,false>)" % (old["name"].split("[")[0],
			"synthesis" if syn else "analysis"),
		diff_to_replaced=relerr(kp, k_old), plain_ms_from="timed with %s" % old["name"])
	print("time   %-15s %-6s %s: kernel %.4f ms (%s; wrapper call %.4f ms), plain %.2f ms, "
		"bound %.4f ms (%s, %.1f %% of it reached), torch.bmm %.4f ms; the %s launch it replaces "
		"%.4f ms (%.2fx: %s), results %.3e apart" % (pname, mode, rec["shape"], ms, how,
		rec["call_ms"], rec["plain_ms"], rec["bound_ms"], rec["bound_by"], 100*rec["bound_ms"]/ms,
		rec["library_ms"], k34, old["ms"], old["ms"]/ms, "faster" if ms < old["ms"] else "NOT faster",
		rec["diff_to_replaced"]))
	return rec


def polar_shapes(pname, mode):
	"""pname (polar_analysis or polar_synthesis) against its float64 plain
	version at two more shapes. (1) Where its ring-tile loop runs and no
	tiling divides the m rows: the 202 near-pole rings of a 3929-ring
	Clenshaw-Curtis map at lmax 750, the poles among them (where the spin
	modes take their limits), 130 m rows, and 6 columns, which take two
	launches (4 + 2) into one output. (2) The lmax-2000 main path's: the
	near-pole rings of the 2160-ring Fejer-1 map (synthesis) or of its
	upsampled rings (analysis), the near-pole m rows, the mode's columns."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	s = mode_spin(mode)
	cc = sht.ring_theta("CC", 3929)
	syn = pname == "polar_synthesis"
	f1 = sht.ring_theta("F1", 2160 if syn else fft.fft_len(2*2000 + 3, direction="above"))
	pm = (sht_cuda.POLAR_MMAX if s is None else max(sht_cuda.POLAR_MMAX, s + 1)) - 1
	for i, (th, lmax, mmax, C) in enumerate(((cc, 750, 129, 6), (f1, 2000, pm, ncoef(mode)))):
		nn, ns = sht_cuda.polar_counts(th, lmax)
		theta = np.concatenate([th[:nn], th[len(th)-ns:]])
		rng = np.random.default_rng(60 + i)
		nf = sht_cuda.NFUN[mode]
		shape = (lmax + 1, mmax + 1, C) if syn else (nf, C, mmax + 1, len(theta))
		x = torch.from_numpy(rng.standard_normal(shape)).cuda()
		g = sht_cuda.geom(theta, mmax, torch.float64, x.device, s)
		ref = sht_cuda.PLAIN[pname](x, g, lmax, mode)
		kp = getattr(sht_cuda, pname)(x, g, lmax, mode)
		torch.cuda.synchronize()
		polar_check(pname, mode, "lmax%d-nt%d-nm%d" % (lmax, len(theta), mmax + 1), kp, ref)


def chunked_library_ms(name, mode, x, theta, lmax, mchunk=64):
	"""(ms, rel err) of the library yardstick of kernel name at a shape whose
	mode-function table [nm, nfun*nt, nl] does not fit in memory whole:
	torch.bmm over m in chunks of mchunk rows, the times of the chunks
	summed. Each chunk multiplies a table of its own shape; the table is
	that of the first chunk (m < mchunk), built once, whose product is held
	against the float64 plain version on those rows. The values do not
	change a dense product's time."""
	from pixell_tpu_torch.ops import sht_cuda
	syn = name.endswith("synthesis")
	head = lambda a: (a[:, :mchunk] if syn else a[..., :mchunk, :]).contiguous()
	T, Bh, layout = library_call(name, mode, head(x), theta, mchunk - 1, lmax)
	ref = sht_cuda.PLAIN[name](head(x).double(), sht_cuda.geom(theta, mchunk - 1, torch.float64,
		x.device, mode_spin(mode)), lmax, mode)
	err = relerr(layout(torch.bmm(T, Bh)), ref)
	ms = chunked_bmm_ms(T, library_operand(name, mode, x, len(theta))[0], mchunk)
	del T, Bh
	torch.cuda.empty_cache()
	return ms, err


def chunked_bmm_ms(T, B, mchunk):
	"""The summed times of torch.bmm(T, B chunk) over B's m rows in chunks of
	mchunk, T the table of one chunk."""
	ms = 0.0
	for m0 in range(0, B.shape[0], mchunk):
		Bc = B[m0:m0 + mchunk].contiguous()
		Tc = T[:len(Bc)]
		ms += cuda_ms(lambda: torch.bmm(Tc, Bc), 3)
	return ms


def timed_once(fn):
	"""(fn(), ms): one call, timed with CUDA events, without warmup (for
	the plain versions, whose seconds dwarf a first call's set-up)."""
	t0 = torch.cuda.Event(enable_timing=True)
	t1 = torch.cuda.Event(enable_timing=True)
	t0.record()
	out = fn()
	t1.record()
	torch.cuda.synchronize()
	return out, t0.elapsed_time(t1)


def lstop_phase():
	"""The dead-tile skip at the lmax-2000 float32 shapes, the same launch
	with the table and without: K1 on the map's 1080 northern rings and K3
	on its 2160 rings (scalar, spin2; K3 also wigner), K4 on the two chunks
	of the upsampled bulk rings. Each is held against the float64 plain
	version by the kernel phase's float32 rule. The main path's launches (K1
	scalar and spin2, K3 wigner, K4 on the first chunk) get their bound and
	the chunked torch.bmm yardstick. Returns their records, each with the
	path whose launches it reports: {key: (record, path label, kernel)}."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	lmax = 2000
	th_up = sht.ring_theta("F1", fft.fft_len(2*lmax + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th_up, lmax)
	bulk = th_up[nn:len(th_up)-ns]
	th_map = sht.ring_theta("F1", 2160)
	rings = {"map": th_map, "north": th_map[:sht_cuda.detect_sym(th_map)],
		"chunk 1": bulk[:sht_cuda.TCHUNK], "chunk 2": bulk[sht_cuda.TCHUNK:]}
	seeds = {"map": 40, "north": 43, "chunk 1": 41, "chunk 2": 42}
	# (mode, bound on the skip's difference, [(kernel, ring set, path of the
	# main path's launches or None)]): K1 on the map's northern rings, K3 on
	# the map's rings, K4 on the two chunks its bulk takes on the main path
	cases = (("scalar", 1e-9, (("sym_synthesis", "north", "scalar lmax 2000"),
			("full_synthesis", "map", None), ("full_analysis", "chunk 1", "scalar lmax 2000"),
			("full_analysis", "chunk 2", None))),
		("spin2", 1e-7, (("sym_synthesis", "north", "spin2 lmax 2000"), ("full_synthesis", "map", None),
			("full_analysis", "chunk 1", "spin2 lmax 2000"))),
		("wigner", 1e-7, (("full_synthesis", "map", "wigner lmax 2000"),
			("full_analysis", "chunk 1", "wigner lmax 2000"), ("full_analysis", "chunk 2", None))))
	records = {}
	for mode, tol, runs_of_mode in cases:
		s = mode_spin(mode)
		for name, where, path in runs_of_mode:
			theta = rings[where]
			kern, C, nt = getattr(sht_cuda, name), ncoef(mode), len(theta)
			bname, pat = sht_cuda.BULK_KERNELS[name], kernel_pattern(name)
			x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt, seeds[where])).to(dev,
				torch.float32)
			g = sht_cuda.geom(theta, lmax, torch.float32, dev, s)
			dead = sht_cuda.dead_stops(theta, lmax, lmax, s or 0, dev)
			if dead is None:
				raise RuntimeError("lstop %s %s: no dead tile at lmax %d" % (name, mode, lmax))
			b_skip, b_by = bound(kernel_ops(name, mode, lmax, lmax, nt, C, dead),
				kernel_bytes(name, mode, lmax, lmax, nt, C, 4), torch.float32)
			b_full, _ = bound(kernel_ops(name, mode, lmax, lmax, nt, C),
				kernel_bytes(name, mode, lmax, lmax, nt, C, 4), torch.float32)
			skip, full = kern(x, g, lmax, mode, dead), kern(x, g, lmax, mode, None)
			torch.cuda.synchronize()
			diff = relerr(skip, full)
			ms, how = kernel_ms(lambda: kern(x, g, lmax, mode, dead), 5, pat)
			ms_nodead, how_nodead = kernel_ms(lambda: kern(x, g, lmax, mode, None), 5, pat)
			ok = diff <= tol and bool(torch.isfinite(skip).all())
			print("lstop  %-14s %-6s lmax %d, nm %d, nt %d (%s), C %d, f32: %d of %d blocks dead; "
				"with the table %.4f ms (%s; bound %.4f), without %.4f ms (%s; bound %.4f); "
				"difference %.3e of the largest value (bound %.0e) %s" % (name, mode, lmax, lmax + 1,
				nt, where, C, int((dead == 0).sum()), dead.numel(), ms, how, b_skip, ms_nodead,
				how_nodead, b_full, diff, tol, "ok" if ok else "FAIL"))
			if not ok:
				raise RuntimeError("lstop %s %s: the skipped tiles are not negligible" % (name, mode))
			# against the float64 plain version, by the kernel phase's float32 rule
			ref = sht_cuda.PLAIN[name](x.double(), sht_cuda.geom(theta, lmax, torch.float64, dev, s),
				lmax, mode, dead)
			p, plain_ms = timed_once(lambda: sht_cuda.PLAIN[name](x, g, lmax, mode, dead))
			err, perr = relerr(skip, ref), relerr(p, ref)
			rtol = 2*perr + 1e-6
			ke = kept_err(name, skip, p, ref, f32_kept(theta, lmax, lmax, dev, s))
			ok = err <= rtol and (ke is None or ke[0] <= 2*ke[1] + 1e-6)
			print("kernel %-14s %-6s lmax %d, nm %d, nt %d (%s), f32, dead-tile table: %s rel err "
				"%.3e (plain %.3e, bound %.3e)%s %s" % (name, mode, lmax, lmax + 1, nt, where, pat, err,
				perr, rtol, "" if ke is None else "; kept entries %.3e (plain %.3e)" % ke,
				"ok" if ok else "FAIL"))
			if not ok:
				raise RuntimeError("%s %s at lmax %d (%s): the bulk kernel disagrees with the float64 "
					"plain version" % (name, mode, lmax, where))
			if path is None: continue
			lib_ms, lib_err = chunked_library_ms(name, mode, x, theta, lmax)
			print("library %-14s %-6s lmax %d (%s): torch.bmm over m in chunks of 64 rows %.4f ms, "
				"rel err %.3e against the float64 plain version on the first chunk (bound 1e-4)" % (
				name, mode, lmax, where, lib_ms, lib_err))
			if not lib_err <= 1e-4:
				raise RuntimeError("%s %s: the chunked yardstick computes another function" % (name, mode))
			rec = {"name": "%s[%s, lmax-2000 %s]" % (bname, mode, where), "route": "cuda",
				"source": LEGENDRE_SOURCE, "replaces": REPLACES[name], "mode": mode,
				"max_abs_err": float((skip.double() - ref).abs().max()), "rel_err": err,
				"plain_rel_err": perr, "ms": ms, "ms_from": how,
				"call_ms": cuda_ms(lambda: kern(x, g, lmax, mode, dead), 5),
				"ms_without_dead_table": ms_nodead, "plain_ms": plain_ms, "bound_ms": b_skip,
				"bound_by": b_by, "library_ms": lib_ms,
				"library_from": "torch.bmm over m in chunks of 64 rows, times summed",
				"library_rel_err": lib_err,
				"shape": "lmax %d, nm %d, nt %d, C %d, float32, dead-tile table" % (lmax, lmax + 1,
				nt, C)}
			print("time   %-14s %-6s lmax-2000 %s: %s %.4f ms (%s; wrapper call %.4f ms), bound %.4f ms "
				"(%.1f %% of it reached), plain %.2f ms, torch.bmm in chunks %.4f ms" % (name, mode,
				where, bname, ms, how, rec["call_ms"], b_skip, 100*b_skip/ms, plain_ms, lib_ms))
			records[(name, mode)] = (rec, path, bname)
	return records


# ---------------------------------------------------------------------------
# 3. the slice through the public API
# ---------------------------------------------------------------------------
def spectrum(lmax, spin):
	"""A diagonal spectrum [ncomp, ncomp, nl] for the components of spin:
	flat, without the l < s modes a spin-s field cannot carry."""
	comps = [c for s in spin for c in ([0] if s == 0 else [s, s])]
	ps = np.zeros((len(comps), len(comps), lmax + 1))
	for i, s in enumerate(comps): ps[i, i, s:] = 1.0/(1 + i)
	return ps


def roundtrip(lmax, shape, dtype, alm_tol, spin=(0,), device="cuda", seed=0):
	"""rand_alm -> alm2map -> map2alm -> alm2map on a full-sky Fejer-1 map.
	Returns (map, alm after the roundtrip)."""
	from pixell_tpu_torch import enmap, curvedsky
	cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	ps = spectrum(lmax, spin)
	alm = curvedsky.rand_alm(ps, lmax=lmax, seed=seed, dtype=cdt, device=device)
	if list(spin) == [0]: alm = alm[0]
	mshape = gshape if alm.ndim == 1 else (alm.shape[0],) + gshape
	m = curvedsky.alm2map(alm, enmap.zeros(mshape, wcs, dtype, device), spin=list(spin))
	alm2 = curvedsky.map2alm(m, lmax=lmax, spin=list(spin))
	m2 = curvedsky.alm2map(alm2, enmap.zeros(mshape, wcs, dtype, device), spin=list(spin))
	if device == "cuda": torch.cuda.synchronize()
	for name, x, want in [("map", m.data, mshape), ("alm", alm2, alm.shape),
			("map2", m2.data, mshape)]:
		if tuple(x.shape) != tuple(want) or not bool(torch.isfinite(x).all()):
			raise RuntimeError("%s: bad output %s %s" % (name, tuple(x.shape), x.dtype))
	ealm, emap = relerr(alm2, alm), relerr(m2.data, m.data)
	print("roundtrip spin %s lmax %d %s %s on %s: alm rel err %.3e (bound %.1e), "
		"band-limited map rel err %.3e (bound 1e-3)" % (list(spin), lmax, shape,
		str(dtype)[6:], device, ealm, alm_tol, emap))
	if not (ealm <= alm_tol and emap < 1e-3):
		raise RuntimeError("roundtrip spin %s lmax %d %s outside its bounds" % (spin, lmax, dtype))
	return m.data, alm2


def deriv_pair(lmax, shape, dtype, device="cuda", seed=2):
	"""deriv=True alm2map of a random alm and map2alm of that gradient map."""
	from pixell_tpu_torch import enmap, curvedsky
	cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	# drawn in complex128 for both dtypes: rand_alm draws another stream in complex64
	alm = curvedsky.rand_alm(np.ones(lmax + 1), lmax=lmax, seed=seed, device=device).to(cdt)
	d = curvedsky.alm2map(alm, enmap.zeros((2,) + gshape, wcs, dtype, device), deriv=True)
	a = curvedsky.map2alm(d, lmax=lmax, deriv=True)
	if device == "cuda": torch.cuda.synchronize()
	for x, want in [(d.data, (2,) + gshape), (a, alm.shape)]:
		if tuple(x.shape) != tuple(want) or not bool(torch.isfinite(x).all()):
			raise RuntimeError("deriv: bad output %s %s" % (tuple(x.shape), x.dtype))
	return d.data, a


def drive(label, mode, fn, kernels, want=None, alm2maps=2):
	"""Run the float32 path fn with every launch count set to 0 just before
	and read just after; every kernel in kernels must have launched in mode,
	and K3 and K4 in no mode in float64: the near-pole passes are
	polar_synthesis's (one launch in mode for each of the path's alm2maps)
	and polar_analysis's. The counts include K9's, which no SHT path calls.
	want, if given, is every nonzero count the path should give, {(kernel,
	mode, dtype): launches}; the counts by dtype, in all modes, must equal
	it."""
	from pixell_tpu_torch.ops import sht_cuda, fma_peak
	sht_cuda.reset_launches()
	fma_peak.LAUNCHES["fma_peak"] = 0
	out = fn()
	counts = {k: sht_cuda.LAUNCHES_BY_MODE[(k, mode)] for k in sht_cuda.KERNELS}
	counts["fma_peak"] = fma_peak.LAUNCHES["fma_peak"]
	print("launches in the %s path (%s mode): %s" % (label, mode, counts))
	missing = [k for k in kernels if counts[k] == 0]
	if missing:
		raise RuntimeError("kernels not launched by the %s path: %s" % (label, missing))
	by_dtype = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	k34_64 = {k: n for k, n in by_dtype.items() if k[0].startswith("full") and k[2] == "float64"}
	if k34_64:
		raise RuntimeError("the %s path ran K3/K4 in float64 (%s), not polar_synthesis and "
			"polar_analysis" % (label, k34_64))
	old32 = {k: n for k, n in by_dtype.items() if k[0] in sht_cuda.BULK_KERNELS and k[2] == "float32"}
	if old32:
		raise RuntimeError("the %s path ran a float32 launch outside the bulk kernels (%s)"
			% (label, old32))
	if counts["polar_synthesis"] != alm2maps:
		raise RuntimeError("the %s path launched polar_synthesis %d times in %s mode, not once for "
			"each of its %d alm2map calls" % (label, counts["polar_synthesis"], mode, alm2maps))
	if want is not None:
		print("launches by (kernel, mode, dtype): %s" % by_dtype)
		if by_dtype != want:
			raise RuntimeError("the %s path should launch %s" % (label, want))
	counts.update({(k, dt): n for (k, md, dt), n in by_dtype.items() if md == mode})
	return counts, out


def wigner_launches(lmax, nt_map):
	"""{(kernel, mode, dtype): launches} of one float32 spin [0, 3] roundtrip
	(alm2map, map2alm, alm2map) on nt_map Fejer-1 rings, after the dispatch:
	the spin-3 block runs K3/K4 in wigner mode, float32 with one float64
	near-pole pass each (polar_synthesis, polar_analysis), its
	analysis in TCHUNK chunks of the upsampled bulk rings; the spin-0 block
	runs as in the spin-0 roundtrip."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	nt_up = fft.fft_len(2*lmax + 3, direction="above")
	nn, ns = sht_cuda.polar_counts(sht.ring_theta("F1", nt_up), lmax)
	chunks = -(-(nt_up - nn - ns)//sht_cuda.TCHUNK)
	want = {("full_bulk_synthesis", "wigner", "float32"): 2, ("polar_synthesis", "wigner", "float64"): 2,
		("full_bulk_analysis", "wigner", "float32"): chunks, ("polar_analysis", "wigner", "float64"): 1,
		("polar_synthesis", "scalar", "float64"): 2, ("polar_analysis", "scalar", "float64"): 1}
	if nt_map <= 2*sht_cuda.SYM_MAX_NH: want[("sym_bulk_synthesis", "scalar", "float32")] = 2
	else: want[("full_bulk_synthesis", "scalar", "float32")] = 2
	if nt_up - nn - ns <= 2*sht_cuda.SYM_MAX_NH: want[("sym_bulk_analysis", "scalar", "float32")] = 1
	else: want[("full_bulk_analysis", "scalar", "float32")] = chunks
	return want


def wigner_against_spin2(lmax, nt):
	"""The wigner mode at spin 2 against the spin2 mode, which reaches w and
	x by another route, on the card in float64 (the engine entry points:
	K3/K4 against K1/K2)."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	theta = sht.ring_theta("F1", nt)
	rng = np.random.default_rng(12)
	A = torch.from_numpy(rng.standard_normal((lmax + 1, lmax + 1, 4))).cuda()
	F = torch.from_numpy(rng.standard_normal((2, 4, lmax + 1, nt))).cuda()
	f64 = torch.float64
	e = (relerr(sht_cuda.synthesis_scan(A, theta, lmax, lmax, "wigner", f64, 2),
			sht_cuda.synthesis_scan(A, theta, lmax, lmax, "spin2", f64)),
		relerr(sht_cuda.analysis_scan(F, theta, lmax, lmax, "wigner", f64, 2),
			sht_cuda.analysis_scan(F, theta, lmax, lmax, "spin2", f64)))
	print("wigner at spin 2 against the spin2 mode, lmax %d, %d rings, f64 on the card: "
		"synthesis rel err %.3e, analysis rel err %.3e (bound 1e-10)" % ((lmax, nt) + e))
	if not max(e) <= 1e-10: raise RuntimeError("the wigner mode at spin 2 is not the spin2 mode")


def slice_phase():
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	# at lmax 750 the float32 bulk takes K1/K2, the near-pole rings
	# polar_synthesis and polar_analysis in float64
	allk = ("sym_bulk_synthesis", "sym_bulk_analysis", "polar_synthesis", "polar_analysis")
	f32, f64 = torch.float32, torch.float64
	launches = {}
	counts, _ = drive("spin-0 lmax-750 f32 roundtrip", "scalar",
		lambda: roundtrip(750, (900, 1800), f32, 1e-4), allk)
	launches["scalar"] = counts
	roundtrip(750, (900, 1800), f64, 1e-10)
	# more than 2*SYM_MAX_NH upsampled rings: the analysis runs K4, not K2
	counts, _ = drive("spin-0 lmax-2000 f32 roundtrip", "scalar",
		lambda: roundtrip(2000, (2160, 4320), f32, 5e-4),
		("sym_bulk_synthesis", "polar_synthesis", "full_bulk_analysis", "polar_analysis"))
	launches["scalar lmax 2000"] = counts
	counts, _ = drive("IQU lmax-750 f32 roundtrip", "spin2",
		lambda: roundtrip(750, (900, 1800), f32, 5e-4, spin=(0, 2)), allk)
	launches["spin2"] = counts
	roundtrip(750, (900, 1800), f64, 1e-10, spin=(0, 2))
	counts, _ = drive("IQU lmax-2000 f32 roundtrip", "spin2",
		lambda: roundtrip(2000, (2160, 4320), f32, 2e-3, spin=(0, 2)),
		("sym_bulk_synthesis", "polar_synthesis", "full_bulk_analysis", "polar_analysis"))
	launches["spin2 lmax 2000"] = counts
	# K4's f32 bulk: the upsampled rings minus the near-pole ones, in
	# TCHUNK chunks; one float64 near-pole launch of polar_analysis
	nt_up = fft.fft_len(2*2000 + 3, direction="above")
	nn, ns = sht_cuda.polar_counts(sht.ring_theta("F1", nt_up), 2000)
	want = -(-(nt_up - nn - ns)//sht_cuda.TCHUNK)
	for md in ("scalar", "spin2"):
		c = launches["%s lmax 2000" % md]
		if (c["full_bulk_analysis"], c["polar_analysis"]) != (want, 1):
			raise RuntimeError("%s analysis launches at lmax 2000: K4's bulk %d, polar_analysis %d; "
				"expected %d (f32 bulk chunks) and 1 (the near-pole pass)" % (md,
				c["full_bulk_analysis"], c["polar_analysis"], want))
	counts, _ = drive("spin-1 lmax-750 f32 roundtrip", "spin1",
		lambda: roundtrip(750, (900, 1800), f32, 5e-4, spin=(1,)), allk)
	launches["spin1"] = counts
	counts, (d32, a32) = drive("deriv lmax-750 f32", "deriv",
		lambda: deriv_pair(750, (900, 1800), f32), allk, alm2maps=1)
	launches["deriv"] = counts
	wk = ("full_bulk_synthesis", "full_bulk_analysis", "polar_synthesis", "polar_analysis")
	counts, _ = drive("spin-[0, 3] lmax-750 f32 roundtrip", "wigner",
		lambda: roundtrip(750, (900, 1800), f32, 5e-4, spin=(0, WIGNER_SPIN)), wk,
		wigner_launches(750, 900))
	launches["wigner"] = counts
	roundtrip(750, (900, 1800), f64, 1e-10, spin=(0, WIGNER_SPIN))
	counts, _ = drive("spin-[0, 3] lmax-2000 f32 roundtrip", "wigner",
		lambda: roundtrip(2000, (2160, 4320), f32, 2e-3, spin=(0, WIGNER_SPIN)), wk,
		wigner_launches(2000, 2160))
	launches["wigner lmax 2000"] = counts
	wigner_against_spin2(750, 900)
	d64, a64 = deriv_pair(750, (900, 1800), f64)
	e = (relerr(d32, d64), relerr(a32, a64))
	print("deriv lmax 750 f32 against f64 on the card: gradient map rel err %.3e, "
		"map2alm rel err %.3e (bound 1e-3)" % e)
	if not max(e) <= 1e-3: raise RuntimeError("deriv f32 outside its bound")
	# small transforms on the card against the same transforms on the CPU
	for label, fn in [
			("spin 0", lambda dev: roundtrip(48, (60, 120), f64, 1e-10, device=dev, seed=1)),
			("spin 1", lambda dev: roundtrip(48, (60, 120), f64, 1e-10, spin=(1,), device=dev,
				seed=1)),
			("spin 3", lambda dev: roundtrip(48, (60, 120), f64, 1e-10, spin=(WIGNER_SPIN,),
				device=dev, seed=1)),
			("deriv", lambda dev: deriv_pair(48, (60, 120), f64, device=dev))]:
		(xc, ac), (xh, ah) = fn("cuda"), fn("cpu")
		e = max(relerr(xc.cpu(), xh), relerr(ac.cpu(), ah))
		print("card vs cpu, %s at lmax 48 f64: rel err %.3e (bound 1e-10)" % (label, e))
		if not e <= 1e-10: raise RuntimeError("card and CPU paths disagree (%s)" % label)
	return launches


# ---------------------------------------------------------------------------
# 4. the block-Legendre split
# ---------------------------------------------------------------------------
# split against unsplit, of the largest value: the bounds of the reference's
# tests/test_pallas.py test_blocked_legendre_split
BLK_TOL = {"scalar": 3e-5, "deriv": 5e-5, "spin1": 5e-5, "spin2": 2e-4}
BLK_LMAX = 2000
BAND_ROWS = slice(324, 1356)   # declinations -63 .. +23 degrees of the 2160-row grid


def blk_counts(tab, lmax, nm):
	"""(m rows x degrees, m rows x blocks) the block kernels run on the
	tiles of tab: every degree from its tile's first block to lmax."""
	from pixell_tpu_torch.ops import sht_cuda
	start = tab.start.cpu().numpy().astype(np.int64)
	nlb = -(-(lmax + 1)//sht_cuda.BLK_LB)
	rows = np.minimum(tab.tile_m, nm - np.arange(start.shape[0])*tab.tile_m)[:, None]
	deg = np.maximum(lmax + 1 - start*sht_cuda.BLK_LB, 0)
	return int((rows*deg).sum()), int((rows*np.maximum(nlb - start, 0)).sum())


def blk_ops(name, mode, tab, lmax, nm, C):
	"""Operations of a block kernel's own arithmetic (an FMA counts 2). Per
	m row and degree, at each of the 128 nodes: the two chain steps (6) and,
	per column and stream, two fold FMAs (synthesis) or the two weighted
	products and their sums (6, analysis) plus the node sum's add. Per m row
	and block: the node -> ring product of the fold rows and the four chain
	ends over the tile's rings (synthesis), or the ring -> node contraction
	of the weighted fields and the chain-end product (analysis), 2 x rows x
	128 x tile_t, and the emission from the state (a few per ring, counted
	as 4 per row)."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	NS, JP = len(sht_core.BLK_FAM[mode]), sht_cuda.BLK_JP
	mdeg, mblk = blk_counts(tab, lmax, nm)
	rows = 2*NS*C + 4
	if name == "blk_synthesis":
		return mdeg*JP*(6 + 4*NS*C) + mblk*tab.tile_t*rows*(2*JP + 4)
	return mdeg*JP*(6 + 6*NS*C + C) + mblk*tab.tile_t*rows*(2*JP + 4)


def blk_tc_bound(mode, tab, lmax, nm, C):
	"""(least ms, FP32 operations, TF32 product FLOPs) of blk_analysis with
	its products on the tensor cores in 3xTF32: the build (the two chain
	steps, 6 per node and degree) over the FP32 peak, plus three times the
	products' FLOPs over the dense TF32 peak. The products: per m row and
	block the ring -> node contraction of the 2 NS C weighted fields and
	the chain-end product of the four ends, 2 x rows x 128 x tile_t; per m
	row and degree the node sums of the 2 x 128 chain values against the NS
	C columns, 2 x 256 x NS C."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	NS, JP = len(sht_core.BLK_FAM[mode]), sht_cuda.BLK_JP
	mdeg, mblk = blk_counts(tab, lmax, nm)
	build = mdeg*JP*6
	prod = mblk*tab.tile_t*JP*2*(2*NS*C + 4) + mdeg*2*2*JP*NS*C
	return 1e3*(build/PEAK_FLOPS[torch.float32] + 3*prod/PEAK_TF32), build, prod


def blk_library_ms(name, mode, x, theta, tab, tab64, state64, lmax, mchunk=64):
	"""(ms, rel err) of the block kernels' library yardstick: the torch.bmm
	over m of K3's or K4's (name's) precomputed mode table, masked to each
	(m, ring)'s blocked suffix (degrees l >= BLK_LB start of its tile, none
	where the tile has none), TF32 off, over m in chunks of mchunk rows with
	the times summed, as chunked_library_ms. The first chunk's product is
	held against the float64 plain block kernel resumed from state64 (the
	float64 scan's state, unscaled, at level 0) on those rows."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	syn, nt, dev, nl = name.endswith("synthesis"), len(theta), x.device, lmax + 1
	head = lambda a: (a[:, :mchunk] if syn else a[..., :mchunk, :]).contiguous()
	T = mode_table(theta, mchunk - 1, lmax, mode, x.dtype, dev)          # [mchunk, nf*nt, nl]
	nf = T.shape[1]//nt
	start = tab.start[:mchunk//tab.tile_m].long().repeat_interleave(tab.tile_m, 0)
	lfirst = (sht_cuda.BLK_LB*start).repeat_interleave(tab.tile_t, 1)[:, :nt]   # [mchunk, nt]
	keep = torch.arange(nl, device=dev)[None, None, :] >= lfirst[:, :, None]
	T.view(mchunk, nf, nt, nl).mul_(keep[:, None])
	del keep
	if not syn: T = T.transpose(1, 2)
	Bh, layout = library_operand(name, mode, head(x), nt)
	tabh = sht_core.BlkTables(tab.start[:mchunk//tab.tile_m].contiguous(), tab64.ctv, tab64.W,
		tab.tile_m, tab.tile_t)
	g64h = sht_cuda.geom(theta, mchunk - 1, torch.float64, dev)
	ref = sht_cuda.PLAIN["blk_" + name.split("_")[1]](head(x).double(),
		state64[:, :mchunk].contiguous(), tabh, g64h, lmax, mode)
	err = relerr(layout(torch.bmm(T, Bh)), ref)
	ms = chunked_bmm_ms(T, library_operand(name, mode, x, nt)[0], mchunk)
	del T, Bh
	torch.cuda.empty_cache()
	return ms, err


def blk_build_check():
	"""Registers and spills (ptxas -v) of every blk_analysis_kernel
	instantiation, and the count of its tensor-core instructions (HMMA,
	HGMMA) in cuobjdump -sass of the built objects. Raises on a spill or a
	count of 0. Returns {mode: (C, registers, spill bytes, count), ...}."""
	from pixell_tpu_torch.ops import _build
	d = _build.build_dir()
	rows = print_build_summary((d/"build.log").read_text(), only="blk_analysis")
	tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
	counts = {}
	for k, mode in enumerate(MODES[:4]):
		r = subprocess.run([tool, "-sass", str(d/("blockleg.%d.o" % k))], capture_output=True,
			text=True, check=True)
		fn = None
		for line in r.stdout.splitlines():
			m = re.search(r"Function : (\S+)", line)
			if m:
				c = re.search(r"blk_analysis_kernelILi(\d+)E", m.group(1))
				fn = (mode, int(c.group(1))) if c else None
				if fn: counts.setdefault(fn, 0)
			elif fn and re.search(r"\bHG?MMA\.", line):
				counts[fn] += 1
	out = {}
	for obj, entry, regs, spill in rows:
		c = int(re.search(r"C=(\d+)", entry).group(1))
		mode = obj.split(".")[1]
		n = counts.get((mode, c), 0)
		out.setdefault(mode, []).append((c, regs, spill, n))
		print("blk_analysis_kernel<C=%d> %s: %d registers, %d bytes spilled, %d tensor-core (HMMA/HGMMA) "
			"instructions in its SASS" % (c, mode, regs, spill, n))
		if spill or not n:
			raise RuntimeError("blk_analysis_kernel<C=%d> %s: %d bytes spilled, %d HMMA" % (c, mode, spill, n))
	if len(rows) != 8 or len(counts) != 8:
		raise RuntimeError("blk_analysis_kernel: %d ptxas entries and %d SASS functions, not 8"
			% (len(rows), len(counts)))
	return out


def blk_bytes(name, mode, tab, lmax, nm, nt, C):
	"""Each input read once and each output written once, in float32."""
	from pixell_tpu_torch.ops import sht_core
	nl, nf, NS = lmax + 1, sht_core.NFUN[mode], len(sht_core.BLK_FAM[mode])
	tables = (2 + (NS if mode != "scalar" else 0))*nl*nm + tab.start.numel() \
		+ tab.ctv.numel() + tab.W.numel() + (0 if mode == "scalar" else 4*nt)
	return 4*(nl*nm*C + nf*C*nm*nt + 3*nm*nt + tables)


def blocked_share(theta, lmax, tab, lstop):
	"""The share of the live (l, m, theta) triples of K3/K4 on the rings
	theta that the split hands to the block kernels."""
	from pixell_tpu_torch.ops import sht_cuda
	nm, nt = lmax + 1, len(theta)
	stop = sht_cuda.stop_entries(lstop, nm, nt).cpu().numpy().astype(np.int64)
	dead = sht_cuda.dead_stops(theta, lmax, lmax, 0, "cpu")
	live = np.ones((nm, nt), bool) if dead is None else sht_cuda.live_mask(dead, nm, nt).numpy()
	m = np.arange(nm)[:, None]
	total = (np.maximum(lmax + 1 - m, 0)*live).sum()
	suffix = (np.maximum(lmax + 1 - np.maximum(stop, m), 0)*(stop > 0)).sum()
	return float(suffix)/float(total)


def unscaled(state, S):
	"""The true (prev, curr) of a scaled state [3, nm, nt], in float64."""
	return state[:2].double()*torch.exp2(S*state[2].double())


def held(label, err, perr, floor=2e-6):
	"""A float32 kernel's error against the float64 plain version beside the
	float32 plain version's: within twice that plus floor."""
	tol = 2*perr + floor
	ok = err <= tol
	print("blocked %s: rel err %.3e (plain %.3e, bound %.3e) %s" % (label, err, perr, tol,
		"ok" if ok else "FAIL"))
	if not ok: raise RuntimeError("blocked %s: kernel disagrees with its plain version" % label)


def blocked_kernels(mode, theta, records):
	"""K3/K4 with the handoff and the block kernels in mode on the rings
	theta at BLK_LMAX, float32, against their plain versions and against
	the unsplit kernels; adds the block kernels' records."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	dev = torch.device("cuda")
	lmax, C, nt = BLK_LMAX, ncoef(mode), len(theta)
	nl = nm = lmax + 1
	f32, f64 = torch.float32, torch.float64
	split = sht_cuda.blk_tables(theta, lmax, lmax, dev)
	if split is None: raise RuntimeError("blocked: no tile with a blocked suffix at lmax %d" % lmax)
	tab, lstop = split
	nlb = -(-nl//sht_cuda.BLK_LB)
	stop = sht_cuda.stop_entries(lstop, nm, nt)
	handed = (stop > 0) & (stop < nl)          # entries whose state is handed over
	if mode == "scalar":
		print("blocked tiles of %d x %d at lmax %d on %d rings: %d of %d with a suffix, first "
			"blocks %d..%d of %d; the block kernels take %.1f %% of the live (l, m, theta) triples"
			% (tab.tile_m, tab.tile_t, lmax, nt, int((tab.start < nlb).sum()), tab.start.numel(),
			int(tab.start.min()), int(tab.start[tab.start < nlb].max()), nlb,
			100*blocked_share(theta, lmax, tab, lstop.cpu())))
	g32, g64 = sht_cuda.geom(theta, lmax, f32, dev), sht_cuda.geom(theta, lmax, f64, dev)
	dead = sht_cuda.dead_stops(theta, lmax, lmax, 0, dev)
	tab64 = sht_core.BlkTables(tab.start, tab.ctv.double(),
		torch.from_numpy(sht_cuda.blk_node_tables(theta, tab.tile_t)[1]).to(dev), tab.tile_m, tab.tile_t)
	for i, name in enumerate(("full_synthesis", "full_analysis")):
		syn = name.endswith("synthesis")
		kern, blk = getattr(sht_cuda, name), getattr(sht_cuda, "blk_" + name.split("_")[1])
		plain, blk_plain = sht_cuda.PLAIN[name], sht_cuda.PLAIN[blk.__name__]
		x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt, 70 + i)).to(dev)
		x32 = x.float()
		# the stepwise prefix and the state it hands over
		k1, kstate = kern(x32, g32, lmax, mode, lstop, True)
		torch.cuda.synchronize()
		p1, pstate = plain(x32, g32, lmax, mode, lstop, True)
		r1, rstate = plain(x, g64, lmax, mode, lstop, True)
		tag = "%s %s" % (name, mode)
		held("%s prefix" % tag, relerr(k1, r1), relerr(p1, r1))
		S32, S64 = sht_core.scale_log2(f32), sht_core.scale_log2(f64)
		rs = unscaled(rstate, S64)[:, handed]
		held("%s state handed over (unscaled; %d entries)" % (tag, int(handed.sum())),
			relerr(unscaled(kstate, S32)[:, handed], rs), relerr(unscaled(pstate, S32)[:, handed], rs))
		if not bool(((kstate[2] >= -2) & (kstate[2] <= 0))[handed].all()):
			raise RuntimeError("blocked %s: a handed-over level outside -2..0" % tag)
		# the block kernel from that state
		k2 = blk(x32, kstate, tab, g32, lmax, mode)
		torch.cuda.synchronize()
		if not bool(torch.isfinite(k2).all()): raise RuntimeError("blocked blk_%s: non-finite" % tag)
		p2 = blk_plain(x32, kstate, tab, g32, lmax, mode)
		r2 = blk_plain(x, kstate.double(), tab64, g64, lmax, mode)
		held("%s %s suffix from that state" % (blk.__name__, mode), relerr(k2, r2), relerr(p2, r2))
		# prefix + suffix against the unsplit kernel
		full, split = kern(x32, g32, lmax, mode, dead), k1 + k2
		err = relerr(split, full)
		if syn:   # entries of tiles without a suffix
			exact = torch.equal(split[..., ~handed], full[..., ~handed])
		else:     # degrees below every tile's handoff
			first = int(tab.start.min())*sht_cuda.BLK_LB
			exact = torch.equal(split[:first], full[:first])
		ok = 0 < err < BLK_TOL[mode] and exact
		print("blocked %s split against unsplit: difference %.3e of the largest value (bounds 0 < . "
			"< %.0e); %s bit-identical: %s %s" % (tag, err, BLK_TOL[mode],
			"tiles without a suffix" if syn else "degrees below every handoff", exact,
			"ok" if ok else "FAIL"))
		if not ok: raise RuntimeError("blocked %s: split and unsplit kernels disagree" % tag)
		# times: the block kernel, the dumping K3/K4, K3/K4 to the end
		kname = kernel_pattern(name)
		ms_blk, how = kernel_ms(lambda: blk(x32, kstate, tab, g32, lmax, mode), 5,
			"blk_%s_kernel" % name.split("_")[1])
		ms_pre, _ = kernel_ms(lambda: kern(x32, g32, lmax, mode, lstop, True), 5, kname)
		ms_full, _ = kernel_ms(lambda: kern(x32, g32, lmax, mode, dead), 5, kname)
		plain_ms = cuda_ms(lambda: blk_plain(x32, kstate, tab, g32, lmax, mode), 1)
		nbytes = blk_bytes(blk.__name__, mode, tab, lmax, nm, nt, C)
		b_ms, b_by = bound(blk_ops(blk.__name__, mode, tab, lmax, nm, C), nbytes, f32)
		# the float64 state, unscaled, at level 0
		state64 = torch.cat([unscaled(rstate, S64), torch.zeros_like(rstate[:1])])
		lib_ms, lib_err = blk_library_ms(name, mode, x32, theta, tab, tab64, state64, lmax)
		if lib_err > 1e-4:
			raise RuntimeError("blocked %s: the library yardstick is off by %.3e" % (tag, lib_err))
		rec = {"name": "%s[%s]" % (blk.__name__, mode), "route": "cuda", "source": BLOCKLEG_SOURCE,
			"replaces": REPLACES[blk.__name__][0 if mode == "scalar" else 1], "mode": mode,
			"max_abs_err": float((k2.double() - r2).abs().max()), "ms": ms_blk, "ms_from": how,
			"plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
			"stepwise_suffix_ms": ms_full - ms_pre, "prefix_ms": ms_pre, "unsplit_ms": ms_full,
			"shape": "lmax %d, nm %d, nt %d, C %d, float32" % (lmax, nm, nt, C)}
		tc = ""
		if not syn:   # the tensor-core bound beside the FP32 one
			tc_ms, build, prod = blk_tc_bound(mode, tab, lmax, nm, C)
			rec["bound_tc_ms"] = max(tc_ms, 1e3*nbytes/PEAK_BYTES)
			tc = "; with the products in 3xTF32 on the tensor cores %.4f ms (%.3g FP32 operations of " \
				"the build, %.3g TF32 product FLOPs x 3; %.1f %% of it reached)" % (rec["bound_tc_ms"],
				build, prod, 100*rec["bound_tc_ms"]/ms_blk)
		print("time   %-14s %-6s %s: kernel %.4f ms (%s), plain %.2f ms, FP32 bound %.4f ms (%s, %.1f %% "
			"of it reached)%s; torch.bmm of the masked mode table in chunks %.4f ms (rel err %.3e); %s "
			"with the handoff %.4f ms, to the end %.4f ms: the same suffix stepwise %.4f ms, split %.4f ms "
			"against unsplit %.4f ms" % (blk.__name__, mode, rec["shape"], ms_blk, how, plain_ms, b_ms, b_by,
			100*b_ms/ms_blk, tc, lib_ms, lib_err, name, ms_pre, ms_full, ms_full - ms_pre, ms_pre + ms_blk,
			ms_full))
		records[(blk.__name__, mode)] = rec


def blk_drive(label, fn, modes, blocked=True):
	"""Run fn under sht.blocked() (or outside it) with the launch counts set
	to 0 just before and read just after. Inside, both block kernels' counts
	by mode are returned and each mode of modes must have launched the kernel
	given with it; outside, no block kernel may launch."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	sht_cuda.reset_launches()
	with sht.blocked(blocked):
		out = fn()
	torch.cuda.synchronize()
	counts = {(k, md): n for (k, md), n in sht_cuda.LAUNCHES_BY_MODE.items()
		if k in sht_cuda.BLK_KERNELS and n}
	print("launches of the block kernels in %s, %s sht.blocked(): %s" % (label,
		"under" if blocked else "outside", counts))
	if not blocked:
		if counts: raise RuntimeError("%s: block kernels launched outside sht.blocked()" % label)
	else:
		missing = [km for km in modes if not counts.get(km)]
		if missing: raise RuntimeError("%s: not launched under sht.blocked(): %s" % (label, missing))
	return counts, out


def blocked_paths():
	"""The curvedsky calls that take the split, under sht.blocked() and
	outside it. Returns the block kernels' launches by (kernel, mode)."""
	from pixell_tpu_torch import enmap, curvedsky, sht
	lmax, f32 = BLK_LMAX, torch.float32
	shape, wcs = enmap.fullsky_geometry(shape=(2160, 4320), variant="fejer1")
	bshape, bwcs = enmap.slice_geometry(shape, wcs, (BAND_ROWS, slice(None)))
	minfo = curvedsky.analyse_geometry(bshape, bwcs)
	dec = np.degrees(np.pi/2 - minfo.theta)
	print("band geometry %s: case %s, ypad %s, declination %.2f .. %.2f degrees" % (bshape,
		minfo.case, minfo.ypad, dec.min(), dec.max()))
	if minfo.case != "2d" or minfo.ypad[0] <= 0 or len(minfo.theta) != 1032:
		raise RuntimeError("the band is not a 2d geometry of 1032 rings inside the full grid")
	total = {}
	def both(label, fn, modes, tol, ref=None, ref_tol=None):
		"""fn under blocked() and outside: launches, difference, times."""
		counts, a = blk_drive(label, fn, modes)
		_, b = blk_drive(label, fn, modes, blocked=False)
		for km, n in counts.items(): total[km] = total.get(km, 0) + n
		if tuple(a.shape) != tuple(b.shape) or not bool(torch.isfinite(a).all()):
			raise RuntimeError("%s: bad output under sht.blocked()" % label)
		err = relerr(a, b)
		with sht.blocked(): ms_on = cuda_ms(fn, 2)
		ms_off = cuda_ms(fn, 2)
		msg = "blocked path %s: %.3f ms under sht.blocked(), %.3f ms outside; difference %.3e of " \
			"the largest value (bounds 0 < . < %.0e)" % (label, ms_on, ms_off, err, tol)
		ok = 0 < err < tol
		if ref is not None:
			rerr = relerr(a, ref)
			msg += "; alm roundtrip rel err %.3e (bound %.0e)" % (rerr, ref_tol)
			ok = ok and rerr <= ref_tol
		print(msg, "ok" if ok else "FAIL")
		if not ok: raise RuntimeError("blocked path %s outside its bounds" % label)
	def data(x): return x.data if isinstance(x, enmap.ndmap) else x
	cases = [("spin 0", (0,), "scalar", ["scalar"], 5e-4), ("IQU", (0, 2), "spin2", ["scalar", "spin2"], 2e-3),
		("spin 1", (1,), "spin1", ["spin1"], 2e-3)]
	for label, spin, mode, modes, rt_tol in cases:
		alm = curvedsky.rand_alm(spectrum(lmax, spin), lmax=lmax, seed=5, dtype=torch.complex64)
		if list(spin) == [0]: alm = alm[0]
		pre = () if alm.ndim == 1 else (alm.shape[0],)
		m = curvedsky.alm2map(alm, enmap.zeros(pre + shape, wcs, f32), spin=list(spin))
		both("map2alm %s full sky" % label, lambda: curvedsky.map2alm(m, lmax=lmax, spin=list(spin)),
			[("blk_analysis", md) for md in modes], BLK_TOL[mode], alm, rt_tol)
		both("alm2map %s band" % label, lambda: data(curvedsky.alm2map(alm,
			enmap.zeros(pre + bshape, bwcs, f32), spin=list(spin))),
			[("blk_synthesis", md) for md in modes], BLK_TOL[mode])
	alm = curvedsky.rand_alm(np.ones(lmax + 1), lmax=lmax, seed=6, dtype=torch.complex64)
	grad = curvedsky.alm2map(alm, enmap.zeros((2,) + shape, wcs, f32), deriv=True)
	both("map2alm deriv full sky", lambda: curvedsky.map2alm(grad, lmax=lmax, deriv=True),
		[("blk_analysis", "deriv")], BLK_TOL["deriv"])
	both("alm2map deriv band", lambda: data(curvedsky.alm2map(alm,
		enmap.zeros((2,) + bshape, bwcs, f32), deriv=True)), [("blk_synthesis", "deriv")],
		BLK_TOL["deriv"])
	# below BLK_MINL, and on symmetric ring sets, nothing changes
	counts, _ = blk_drive("the spin-0 lmax-750 roundtrip", lambda: roundtrip(750, (900, 1800), f32,
		1e-4), [])
	if counts: raise RuntimeError("block kernels launched at lmax 750")
	return total


def blocked_phase():
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	th_up = sht.ring_theta("F1", fft.fft_len(2*BLK_LMAX + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th_up, BLK_LMAX)
	theta = th_up[nn:len(th_up) - ns][:sht_cuda.TCHUNK]
	build = blk_build_check()
	records = {}
	for mode in ("scalar", "deriv", "spin1", "spin2"):
		blocked_kernels(mode, theta, records)
	launches = blocked_paths()
	for (name, mode), rec in records.items():
		rec["launches"] = launches.get((name, mode), 0)
		if name == "blk_analysis":   # (C, registers, spill bytes, tensor-core instructions)
			rec["ptxas_sass"] = build[mode]
		if rec["launches"] == 0:
			raise RuntimeError("%s in %s mode was not launched by the blocked paths" % (name, mode))
	return records


# ---------------------------------------------------------------------------
# 5. timing
# ---------------------------------------------------------------------------
def roundtrip_step(lmax, shape, spin):
	"""arr -> alm2map(map2alm(arr)) at lmax on the full-sky F1 map, f32."""
	from pixell_tpu_torch import enmap, curvedsky
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	mshape = gshape if list(spin) == [0] else (3,) + gshape
	ainfo = curvedsky.alm_info(lmax=lmax)
	def step(arr):
		alm = curvedsky.map2alm(enmap.ndmap(arr, wcs), lmax=lmax, spin=list(spin))
		return curvedsky.alm2map(alm, enmap.zeros(mshape, wcs, torch.float32),
			spin=list(spin), ainfo=ainfo).data
	rng = np.random.default_rng(0)
	arr = torch.from_numpy(rng.standard_normal(mshape).astype(np.float32)).cuda()
	arr = step(step(arr))   # warmup; the result is band-limited
	torch.cuda.synchronize()
	return step, arr


def time_roundtrips(lmax, shape, nrep, spin=(0,)):
	"""nrep sequential roundtrips, timed with CUDA events (and the host
	clock) after warmup; checks the band-limited map comes back."""
	step, arr = roundtrip_step(lmax, shape, spin)
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
	print("timing: %d x lmax-%d spin %s f32 roundtrip = %.3f ms (%.4f ms each; host clock "
		"%.3f ms); drift after %d roundtrips %.3e" % (nrep, lmax, list(spin), ms, ms/nrep,
		host*1e3, nrep, rel))
	if not rel < 1e-3: raise RuntimeError("timed roundtrips drifted: %g" % rel)
	return ms


def profiled(fn, rows):
	"""(wall ms, device busy ms) of one call of fn under the profiler, whose
	device time by kernel it prints (rows rows); the rest of the wall time is
	the device waiting on the host."""
	from torch.profiler import profile, ProfilerActivity
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		h0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		wall = time.perf_counter() - h0
	ka = prof.key_averages()
	key = _device_key(ka)
	# device-side events only, as the profiler's own "Self CUDA time total"
	busy = sum(getattr(e, key) for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
		and not getattr(e, "is_user_annotation", False))/1e3
	print(ka.table(sort_by=key, row_limit=rows, max_name_column_width=56))
	return wall*1e3, busy


def profile_roundtrips(lmax, shape, nrep=3, spin=(0,)):
	"""Device time by kernel over nrep roundtrips, and the device's busy
	share of the host wall time."""
	step, arr = roundtrip_step(lmax, shape, spin)
	def steps():
		y = arr
		for _ in range(nrep): y = step(y)
	wall, busy = profiled(steps, 14)
	print("profile: %d x lmax-%d spin %s f32 roundtrip: wall %.3f ms, device busy %.3f ms "
		"(%.1f %%)" % (nrep, lmax, list(spin), wall, busy, 100*busy/wall))


# ---------------------------------------------------------------------------
# 6. variants of bulk_analysis_kernel (only on request)
# ---------------------------------------------------------------------------
# Edits of csrc/legendre.cu, each undoing one choice of bulk_analysis_kernel
# (its rings a thread, bulk_rings: four in the full scalar form, else two),
# of bulk_synthesis_kernel (its rings a thread, SYNTH_RINGS: two in scalar
# mode, else one; the half-sky form's even-l and odd-l sums, against north
# and mirror sums) or of both (the way their first-group test is written).
# An edit applies wherever its text appears.
BULK_VARIANTS = {
	"R = 2": ("return MODE == SCALAR && !SYM ? 4 : 2;", "return 2;"),
	"R = 4": ("return MODE == SCALAR && !SYM ? 4 : 2;", "return 4;"),
	"gl0 == l8": ("else if (gl0 < l8 + BG)", "else if (gl0 == l8)"),
	"synthesis R = 1": ("SYNTH_RINGS = MODE == SCALAR ? 2 : 1;", "SYNTH_RINGS = 1;"),
	"synthesis R = 2": ("SYNTH_RINGS = MODE == SCALAR ? 2 : 1;", "SYNTH_RINGS = 2;"),
	"north/mirror sums": ("constexpr bool SYNTH_EVEN_ODD = true;", "constexpr bool SYNTH_EVEN_ODD = false;"),
}


def variant_sources(label, old, new):
	"""A copy of the kernel sources with old replaced by new in legendre.cu
	(every occurrence, at least one), in a directory of its own under
	build/."""
	from pixell_tpu_torch.ops import _build
	d = _build.BUILD_ROOT.parent/"variants"/re.sub(r"\W+", "_", label).strip("_")
	d.mkdir(parents=True, exist_ok=True)
	for p in _build.CSRC.glob("*.cu"):
		text = p.read_text()
		if p.name == "legendre.cu":
			if old not in text: raise RuntimeError("variant %s: its edit does not apply" % label)
			text = text.replace(old, new)
		(d/p.name).write_text(text)
	return d


class use_library:
	"""Within the block, sht_cuda launches from the library built from csrc."""
	def __init__(self, csrc): self.csrc = csrc
	def __enter__(self):
		from pixell_tpu_torch.ops import sht_cuda
		self.lib = sht_cuda.library
		sht_cuda.library = lambda: self.lib(self.csrc)
	def __exit__(self, *exc):
		from pixell_tpu_torch.ops import sht_cuda
		sht_cuda.library = self.lib


def variants_phase():
	"""The bulk kernels' design choices, measured: the sources built once
	per edit of BULK_VARIANTS (all builds started together), and each
	build's bulk kernels run at the main path's shapes (K1 and K2 at lmax
	750 in the four Legendre modes; K3 and K4 in wigner mode at lmax 750;
	K1 on the lmax-2000 map's northern rings and K4 on the first lmax-2000
	chunk in scalar and spin2; K1, K3 and K4 with the dead-tile table), its
	device time beside the committed build's. An analysis result must lie
	within 1e-6 of the largest value of the committed build's. A synthesis
	result is held, on the entries the float32 main path keeps (f32_kept),
	to the kernel phase's float32 rule against the float64 plain version:
	the variants sum in other orders (north and mirror sums, not even and
	odd ones), and in the spin modes the sums of one parity are larger
	than their total, so their rounding moves it by more than 1e-6."""
	from concurrent.futures import ThreadPoolExecutor
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda, _build
	dev = torch.device("cuda")
	builds = {label: variant_sources(label, *edit) for label, edit in BULK_VARIANTS.items()}
	h0 = time.perf_counter()
	with ThreadPoolExecutor(len(builds)) as ex:
		list(ex.map(sht_cuda.library, builds.values()))
	print("variants: %d builds in %.1f s" % (len(builds), time.perf_counter() - h0))
	for label, d in builds.items():
		print("variant %s:" % label)
		print_build_summary((_build.build_dir(d)/"build.log").read_text(), only="bulk_")
	builds = {"committed": _build.CSRC, **builds}
	th = sht.ring_theta("F1", 1512)
	nn, ns = sht_cuda.polar_counts(th, 750)
	b750 = th[nn:len(th)-ns]
	th = sht.ring_theta("F1", fft.fft_len(2*2000 + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th, 2000)
	b2000 = th[nn:len(th)-ns][:sht_cuda.TCHUNK]
	m750, m2000 = sht.ring_theta("F1", 900), sht.ring_theta("F1", 2160)
	legendre = ("scalar", "deriv", "spin1", "spin2")
	cases = [("sym_synthesis", mode, 750, m750[:450]) for mode in legendre] + [
		("sym_analysis", mode, 750, b750[:sht_cuda.detect_sym(b750)]) for mode in legendre] + [
		("full_synthesis", "wigner", 750, m750), ("full_analysis", "wigner", 750, b750),
		("sym_synthesis", "scalar", 2000, m2000[:1080]), ("full_analysis", "scalar", 2000, b2000),
		("sym_synthesis", "spin2", 2000, m2000[:1080]), ("full_analysis", "spin2", 2000, b2000)]
	for i, (name, mode, lmax, theta) in enumerate(cases):
		s = mode_spin(mode)
		x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, len(theta), 70 + i)).to(dev,
			torch.float32)
		g = sht_cuda.geom(theta, lmax, torch.float32, dev, s)
		args = (x, g, lmax, mode)
		if name != "sym_analysis": args += (sht_cuda.dead_stops(theta, lmax, lmax, s or 0, dev),)
		kern = getattr(sht_cuda, name)
		syn = name.endswith("synthesis")
		if syn:   # the float32 rule on the kept entries
			kept = f32_kept(theta, lmax, lmax, dev, s)
			ref64 = sht_cuda.PLAIN[name](x.double(), sht_cuda.geom(theta, lmax, torch.float64, dev, s),
				*args[2:])[..., kept]
			tol = 2*relerr(sht_cuda.PLAIN[name](*args)[..., kept], ref64) + 1e-6
		line, first = [], None
		for label, d in builds.items():
			with use_library(d):
				out = kern(*args)
				torch.cuda.synchronize()
				ms, how = kernel_ms(lambda: kern(*args), 20, kernel_pattern(name))
			first = out if first is None else first
			diff = relerr(out, first)
			ok = relerr(out[..., kept], ref64) <= tol if syn else diff <= 1e-6
			line.append("%s %.4f ms (%s), %.1e apart" % (label, ms, how, diff))
			if not ok:
				raise RuntimeError("variant %s of %s %s computes another function" % (label, name, mode))
		print("variant %s %s lmax %d, nt %d: %s" % (name, mode, lmax, len(theta), "; ".join(line)))


# ---------------------------------------------------------------------------
# 6b. where blk_analysis_kernel's time goes (only with --phases blkprobe)
# ---------------------------------------------------------------------------
# A copy of blockleg.cu in which thread 0 of every block reads clock64() at
# the points below, just after each block-wide barrier of
# blk_analysis_kernel, and adds the cycles since the point before to that
# point's phase; at the end each block adds its sums to a __device__ array
# that pt_blk_probe_<mode> reads and clears. A phase is thus the time from
# one barrier to the next as thread 0 sees it, waits included. Each entry:
# (phase, text of the source, True to insert after it, False before it).
BLK_PROBES = (
	("block start", "      stage_ab(sa, sb, ab, l0, m0, nl, nm, tid, ANT);\n", False),
	("tables, W slab", "        if (il > first) {\n", False),
	("state step", "        {  // X: thread (m row, ring) of the slab\n", False),
	("X", "        {  // Wc|Wp += X W^T", False),
	("contraction", "        __syncthreads();  // the slabs are read\n", True),
	("Wc|Wp", "      if constexpr (HAS_PREV) {\n", False),
	("build", "        {  // warp (m row, half)", False),
	("node sums", "        // the degrees' sums: thread (degree, m row, column)\n", False),
	("weighting", "          if (HAS_PREV && k + 1 < LBK) op[((k + 1) * BM + mi) * C + c] = vp;\n        }\n",
		True),
	("ends", "      // ---- 3. the block's sums to the partial plane ----\n", False),
	("to plane", "        *o = store ? v : *o + v;\n      }\n", True))


def blk_probe_sources():
	"""The kernel sources with blk_analysis_kernel probed (BLK_PROBES), in a
	directory of their own under build/."""
	from pixell_tpu_torch.ops import _build
	d = _build.BUILD_ROOT.parent/"variants"/"blk_probe"
	d.mkdir(parents=True, exist_ok=True)
	n = len(BLK_PROBES)
	for p in _build.CSRC.glob("*.cu"):
		text = p.read_text()
		if p.name == "blockleg.cu":
			for i, (_, at, after) in enumerate(BLK_PROBES):
				if text.count(at) != 1: raise RuntimeError("probe %d: its place is not unique" % i)
				k = text.index(at) + (len(at) if after else 0)
				text = text[:k] + "PT_PROBE(%d);\n" % i + text[k:]
			at = "  const bool store = ntiles <= (int)gridDim.x;"
			text = text.replace(at, "  unsigned long long pt_t = clock64(), pt_sum[%d] = {0};\n%s" % (n, at))
			k = text.index("\n}\n", text.index("PT_PROBE(%d)" % (n - 1)))
			text = text[:k] + "\n  if (threadIdx.x == 0)\n    for (int i = 0; i < %d; ++i) atomicAdd(&pt_probe[i], " \
				"pt_sum[i]);" % n + text[k:]
			text = text.replace("namespace {\n", "namespace {\n__device__ unsigned long long pt_probe[%d];\n"
				"#define PT_PROBE(i) { const unsigned long long t = clock64(); pt_sum[i] += t - pt_t; pt_t = t; }\n"
				% n, 1)
			text += '\nextern "C" int PT_ENTRY(pt_blk_probe)(unsigned long long* out) {\n' \
				"  cudaMemcpyFromSymbol(out, pt_probe, sizeof(pt_probe));\n" \
				"  unsigned long long zero[%d] = {0};\n  cudaMemcpyToSymbol(pt_probe, zero, sizeof(zero));\n" \
				"  return (int)cudaGetLastError();\n}\n" % n
		(d/p.name).write_text(text)
	return d


def blk_probe_phase():
	"""blk_analysis at the blocked phase's shapes (lmax 2000, the first 2048
	bulk upsampled rings, from K4's handed-over state) in each mode from the
	probed build: the share of each phase in thread 0's cycles, and the
	probed kernel's time (CUDA events; the probes cost a little)."""
	import ctypes
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	d = blk_probe_sources()
	lib = sht_cuda.library(d)
	th_up = sht.ring_theta("F1", fft.fft_len(2*BLK_LMAX + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th_up, BLK_LMAX)
	theta = th_up[nn:len(th_up) - ns][:sht_cuda.TCHUNK]
	tab, lstop = sht_cuda.blk_tables(theta, BLK_LMAX, BLK_LMAX, dev)
	g = sht_cuda.geom(theta, BLK_LMAX, torch.float32, dev)
	buf = (ctypes.c_ulonglong*len(BLK_PROBES))()
	for i, mode in enumerate(("scalar", "deriv", "spin1", "spin2")):
		read = getattr(lib, "pt_blk_probe_%s" % mode)
		read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
		x = torch.from_numpy(kernel_input("full_analysis", mode, BLK_LMAX, BLK_LMAX, len(theta),
			71 + i)).to(dev, torch.float32)
		with use_library(d):
			_, state = sht_cuda.full_analysis(x, g, BLK_LMAX, mode, lstop, True)
			fn = lambda: sht_cuda.blk_analysis(x, state, tab, g, BLK_LMAX, mode)
			fn()
			torch.cuda.synchronize()
			read(buf)
			ms = cuda_ms(fn, 3)
			read(buf)
		tot = sum(buf)
		print("blkprobe blk_analysis %s (probed build) %.4f ms per call; thread 0's cycles by phase: %s" % (
			mode, ms, ", ".join("%s %.1f %%" % (name, 100*c/tot) for (name, _, _), c in zip(BLK_PROBES, buf))))


# ---------------------------------------------------------------------------
# 7. the adjoint transforms
# ---------------------------------------------------------------------------
# float32 adjoint outputs against float64 ones, of the largest value: the
# forward guards of the cells, (spin 0, IQU and the other spins) by lmax
ADJ_TOL = {750: (1e-4, 5e-4), 2000: (5e-4, 2e-3)}
ADJ_CASES = {"spin 0": ((0,), False), "IQU": ((0, 2), False), "spin [0, 3]": ((0, WIGNER_SPIN), False),
	"deriv": ((0,), True)}


def alm_dot(x, y):
	"""sum Re(x) Re(y) + Im(x) Im(y) over the stored entries (the reference's
	vjp convention), or the plain sum of products of two real maps, in
	float64."""
	x, y = x.to(torch.complex128 if x.is_complex() else torch.float64), \
		y.to(torch.complex128 if y.is_complex() else torch.float64)
	if x.is_complex(): return float((x.real*y.real).sum() + (x.imag*y.imag).sum())
	return float((x*y).sum())


def adjoint_inputs(lmax, shape, label, seed):
	"""(alm b, map m = alm2map(b), wcs, spin, deriv) in float64 on the card:
	b drawn with the cell's diagonal spectrum (deriv: one alm, flat), m its
	band-limited map on the full-sky Fejer-1 geometry."""
	from pixell_tpu_torch import enmap, curvedsky
	spin, deriv = ADJ_CASES[label]
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	ps = np.ones(lmax + 1) if deriv else spectrum(lmax, spin)
	b = curvedsky.rand_alm(ps, lmax=lmax, seed=seed, device="cuda")
	if list(spin) == [0] and not deriv: b = b[0]
	pre = (2,) if deriv else (() if b.ndim == 1 else (b.shape[0],))
	m = curvedsky.alm2map(b, enmap.zeros(pre + gshape, wcs, torch.float64), spin=list(spin),
		deriv=deriv)
	return b, m.data, wcs, list(spin), deriv


def adjoint_drive(label, fn, rings=None):
	"""A float32 adjoint call fn with every launch count set to 0 just
	before and read just after: it must launch, and only the float32 bulk
	kernels (sht_cuda.BULK_KERNELS) and polar_synthesis / polar_analysis in
	float64, never K3/K4 in float64 nor any other kernel. With rings, the
	ring counts of its full_synthesis calls (dtype, rings, with stops) are
	recorded into that list. Returns (launches by (kernel, mode, dtype),
	fn's result, peak device memory in GiB)."""
	from pixell_tpu_torch.ops import sht_cuda, fma_peak
	full = sht_cuda.full_synthesis
	if rings is not None:
		def recorder(A, g, lmax, mode="scalar", lstop=None, dump_state=False):
			rings.append((str(A.dtype)[6:], g.nt, lstop is not None))
			return full(A, g, lmax, mode, lstop, dump_state)
		sht_cuda.full_synthesis = recorder
	sht_cuda.reset_launches()
	fma_peak.LAUNCHES["fma_peak"] = 0
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	try:
		out = fn()
		torch.cuda.synchronize()
	finally:
		sht_cuda.full_synthesis = full
	peak = torch.cuda.max_memory_allocated()/2**30
	by_dtype = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	print("launches in the %s: %s (peak device memory %.2f GiB)" % (label, by_dtype, peak))
	bulk = set(sht_cuda.BULK_KERNELS.values())
	bad = {k: n for k, n in by_dtype.items() if not ((k[0] in bulk and k[2] == "float32")
		or (k[0] in sht_cuda.POLAR_KERNELS and k[2] == "float64"))}
	if not by_dtype or bad or fma_peak.LAUNCHES["fma_peak"]:
		raise RuntimeError("the %s launched %s: only the float32 bulk kernels and the float64 near-pole "
			"passes may run on a float32 path" % (label, bad or "nothing"))
	return by_dtype, out, peak


def adjoint_cell(lmax, shape, label, seed):
	"""One cell of the adjoint phase: in float64 the dot-product identities
	<map2alm(m), b> = <m, map2alm_adjoint(b)> and <alm2map(b), m> =
	<b, alm2map_adjoint(m)> with m = alm2map(b) (no cancellation in either
	product), within 1e-10 relative; in float32 both adjoint entries on the
	same inputs, their launches checked (adjoint_drive) and their outputs
	held to the cell's forward guard against the float64 ones. Returns the
	float32 calls' launches and the ring records of map2alm_adjoint's
	full_synthesis calls."""
	from pixell_tpu_torch import enmap, curvedsky
	b, m, wcs, spin, deriv = adjoint_inputs(lmax, shape, label, seed)
	ainfo = curvedsky.alm_info(lmax=lmax)
	f32, f64 = torch.float32, torch.float64
	zeros = lambda dt: enmap.zeros(tuple(m.shape), wcs, dt)
	fwd = curvedsky.map2alm(enmap.ndmap(m, wcs), lmax=lmax, spin=spin, deriv=deriv)
	back = curvedsky.map2alm_adjoint(b, zeros(f64), spin=spin, deriv=deriv).data
	a_back = curvedsky.alm2map_adjoint(enmap.ndmap(m, wcs), spin=spin, deriv=deriv, ainfo=ainfo)
	torch.cuda.synchronize()
	for name, x, want in (("map2alm_adjoint", back, tuple(m.shape)), ("alm2map_adjoint", a_back,
			tuple(b.shape))):
		if tuple(x.shape) != want or not bool(torch.isfinite(x).all()):
			raise RuntimeError("%s %s lmax %d: bad output %s" % (name, label, lmax, tuple(x.shape)))
	dots = ((alm_dot(fwd, b), alm_dot(m, back)), (alm_dot(m, m), alm_dot(b, a_back)))
	errs = [abs(l - r)/abs(l) for l, r in dots]
	print("adjoint %-11s lmax %d f64 on the card: <map2alm(m), a> %.15e, <m, map2alm_adjoint(a)> %.15e, "
		"rel diff %.3e; <alm2map(a), m> %.15e, <a, alm2map_adjoint(m)> %.15e, rel diff %.3e (bound "
		"1e-10)" % (label, lmax, dots[0][0], dots[0][1], errs[0], dots[1][0], dots[1][1], errs[1]))
	if not max(errs) <= 1e-10:
		raise RuntimeError("adjoint %s lmax %d: the pair is not adjoint on the card" % (label, lmax))
	m32, b32 = m.to(f32), b.to(torch.complex64)
	rings = []
	launches = {}
	launches["alm2map_adjoint"], a32, _ = adjoint_drive("alm2map_adjoint %s lmax %d f32" % (label, lmax),
		lambda: curvedsky.alm2map_adjoint(enmap.ndmap(m32, wcs), spin=spin, deriv=deriv, ainfo=ainfo))
	launches["map2alm_adjoint"], back32, peak = adjoint_drive("map2alm_adjoint %s lmax %d f32" % (label,
		lmax), lambda: curvedsky.map2alm_adjoint(b32, zeros(f32), spin=spin, deriv=deriv).data, rings)
	tol = ADJ_TOL[lmax][0 if label == "spin 0" else 1]
	e = (relerr(a32, a_back), relerr(back32, back))
	print("adjoint %-11s lmax %d f32 against f64 on the card: alm2map_adjoint rel err %.3e, "
		"map2alm_adjoint rel err %.3e (bound %.0e)" % (label, lmax, e[0], e[1], tol))
	if not max(e) <= tol:
		raise RuntimeError("adjoint %s lmax %d: float32 outside its bound" % (label, lmax))
	return launches, rings, peak


def k3_upsampled(nt_up):
	"""K3's float32 bulk at the shape map2alm_adjoint gives it at lmax 2000:
	all nt_up upsampled Fejer-1 rings, nm 2001, scalar (C = 2), with the
	dead-tile table (and without, for the time): held to the float32 rule
	against the float64 plain version, its time, the plain version's, its
	bound and the chunked torch.bmm yardstick (printed, "K3 row")."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	dev, lmax, mode, name = torch.device("cuda"), 2000, "scalar", "full_synthesis"
	theta = sht.ring_theta("F1", nt_up)
	x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt_up, 44)).to(dev, torch.float32)
	g = sht_cuda.geom(theta, lmax, torch.float32, dev)
	dead = sht_cuda.dead_stops(theta, lmax, lmax, 0, dev)
	k = sht_cuda.full_synthesis(x, g, lmax, mode, dead)
	ref = sht_cuda.PLAIN[name](x.double(), sht_cuda.geom(theta, lmax, torch.float64, dev), lmax, mode, dead)
	p, plain_ms = timed_once(lambda: sht_cuda.PLAIN[name](x, g, lmax, mode, dead))
	ke = kept_err(name, k, p, ref, f32_kept(theta, lmax, lmax, dev))
	if not ke[0] <= 2*ke[1] + 1e-6:
		raise RuntimeError("K3 on the %d upsampled rings disagrees with the float64 plain version" % nt_up)
	pat = kernel_pattern(name)
	ms, how = kernel_ms(lambda: sht_cuda.full_synthesis(x, g, lmax, mode, dead), 5, pat)
	ms_nodead = kernel_ms(lambda: sht_cuda.full_synthesis(x, g, lmax, mode, None), 5, pat)[0]
	b_ms, b_by = bound(kernel_ops(name, mode, lmax, lmax, nt_up, 2, dead),
		kernel_bytes(name, mode, lmax, lmax, nt_up, 2, 4), torch.float32)
	lib_ms, lib_err = chunked_library_ms(name, mode, x, theta, lmax)
	print("K3 row full_bulk_synthesis scalar lmax %d, nm %d, nt %d, C 2, f32, dead-tile table (%d of %d "
		"blocks dead): kernel %.4f ms (%s; without the table %.4f ms), kept entries rel err %.3e (plain "
		"%.3e), plain %.2f ms, bound %.4f ms (%s, %.1f %% of it reached), torch.bmm in chunks %.4f ms "
		"(rel err %.3e)" % (lmax, lmax + 1, nt_up, int((dead == 0).sum()), dead.numel(), ms, how, ms_nodead,
		ke[0], ke[1], plain_ms, b_ms, b_by, 100*b_ms/ms, lib_ms, lib_err))


def adjoint_timing(lmax, shape, spin, nrep):
	"""nrep x (alm2map_adjoint + map2alm_adjoint) in float32, CUDA events
	after warmup, beside nrep forward roundtrips (map2alm + alm2map) of the
	same cell timed the same way in the same call, and each one's device
	busy share from one profiled step."""
	from pixell_tpu_torch import enmap, curvedsky
	step, arr = roundtrip_step(lmax, shape, spin)
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	ainfo = curvedsky.alm_info(lmax=lmax)
	alm = curvedsky.map2alm(enmap.ndmap(arr, wcs), lmax=lmax, spin=list(spin))
	out = enmap.zeros(tuple(arr.shape), wcs, torch.float32)
	def adj():
		a = curvedsky.alm2map_adjoint(enmap.ndmap(arr, wcs), spin=list(spin), ainfo=ainfo)
		return curvedsky.map2alm_adjoint(alm, out, spin=list(spin)).data, a
	res = {}
	for name, fn in (("adjoint", adj), ("forward", lambda: step(arr))):
		ms = cuda_ms(fn, nrep)
		wall, busy = profiled(fn, 10)
		res[name] = (ms, busy, 100*busy/wall)
	print("adjoint timing: %d x lmax-%d spin %s f32: alm2map_adjoint + map2alm_adjoint %.4f ms each "
		"(device busy %.3f ms, %.1f %% of one profiled pair); the forward roundtrip map2alm + alm2map "
		"%.4f ms each (device busy %.3f ms, %.1f %%)" % ((nrep, lmax, list(spin)) + res["adjoint"]
		+ res["forward"]))


def adjoint_phase():
	"""The adjoint transforms through pixell_tpu_torch.curvedsky at full
	width: alm2map_adjoint and map2alm_adjoint at lmax 750 on the 900x1800
	Fejer-1 map (spin 0, IQU, spin [0, 3], deriv) and at lmax 2000 on
	2160x4320 (spin 0, IQU): adjointness in float64, float32 against
	float64, launches, and map2alm_adjoint's float32 K3 bulk
	(full_bulk_synthesis) on the 4032 upsampled rings at lmax 2000; then the
	timings beside the forward roundtrips. Returns the launches of each
	float32 call by (cell, entry)."""
	from pixell_tpu_torch import fft
	out = {}
	for i, label in enumerate(ADJ_CASES):
		launches, _, _ = adjoint_cell(750, (900, 1800), label, 30 + i)
		for entry, c in launches.items(): out[(label + " lmax 750", entry)] = c
	nt_up = fft.fft_len(2*2000 + 3, direction="above")
	for i, label in enumerate(("spin 0", "IQU")):
		launches, rings, peak = adjoint_cell(2000, (2160, 4320), label, 40 + i)
		for entry, c in launches.items(): out[(label + " lmax 2000", entry)] = c
		k3 = [r for r in rings if r == ("float32", nt_up, True)]
		print("map2alm_adjoint %s lmax 2000 f32: full_synthesis calls (dtype, rings, stops) %s; peak "
			"device memory %.2f GiB" % (label, rings, peak))
		if not k3 or not any(k[0] == "full_bulk_synthesis" for k in launches["map2alm_adjoint"]):
			raise RuntimeError("map2alm_adjoint %s at lmax 2000 did not run the float32 K3 bulk on the %d "
				"upsampled rings" % (label, nt_up))
	k3_upsampled(nt_up)
	adjoint_timing(750, (900, 1800), (0,), 10)
	adjoint_timing(750, (900, 1800), (0, 2), 10)
	adjoint_timing(2000, (2160, 4320), (0,), 1)
	return out


PHASES = ("k9", "kernels", "lstop", "slice", "adjoint", "blocked", "timing")
EXTRA_PHASES = ("variants", "blkprobe")   # run only when named


def main():
	ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
	ap.add_argument("--phases", default=",".join(PHASES),
		help="comma-separated choice of %s (default: all but %s)" % (", ".join(PHASES + EXTRA_PHASES),
		", ".join(EXTRA_PHASES)))
	phases = ap.parse_args().phases.split(",")
	if not set(phases) <= set(PHASES + EXTRA_PHASES): ap.error("unknown phase in %s" % phases)
	if not torch.cuda.is_available():
		print("chip_smoke: no CUDA device", file=sys.stderr)
		return 2
	sys.path.insert(0, ROOT)
	from pixell_tpu_torch.ops import sht_cuda, _build
	t_start = time.perf_counter()
	print(card_line())
	print("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
		sys.version.split()[0]))
	torch.backends.cuda.matmul.allow_tf32 = False
	torch.backends.cudnn.allow_tf32 = False
	h0 = time.perf_counter()
	sht_cuda.library()
	print("kernel build + load: %.1f s" % (time.perf_counter() - h0))
	print_build_summary((_build.build_dir()/"build.log").read_text())
	records, kernel_records, launches, blk_records, lstop_records = [], {}, {}, {}, {}
	if "k9" in phases:
		records = fma_phase()
		print("phase K9 done at %.1f s" % (time.perf_counter() - t_start))
	if "kernels" in phases:
		kernel_records = kernel_phase()
		print("phase kernels done at %.1f s" % (time.perf_counter() - t_start))
	if "lstop" in phases:
		lstop_records = lstop_phase()
		print("phase lstop done at %.1f s" % (time.perf_counter() - t_start))
	if "slice" in phases:
		launches = slice_phase()
		print("phase slice done at %.1f s" % (time.perf_counter() - t_start))
	if "adjoint" in phases:
		adjoint_phase()
		print("phase adjoint done at %.1f s" % (time.perf_counter() - t_start))
	if "blocked" in phases:
		blk_records = blocked_phase()
		print("phase blocked done at %.1f s" % (time.perf_counter() - t_start))
	if "timing" in phases:
		w = (0, WIGNER_SPIN)
		time_roundtrips(750, (900, 1800), 40)
		time_roundtrips(2000, (2160, 4320), 5)
		time_roundtrips(750, (900, 1800), 10, spin=(0, 2))
		time_roundtrips(2000, (2160, 4320), 3, spin=(0, 2))
		time_roundtrips(750, (900, 1800), 10, spin=w)
		time_roundtrips(2000, (2160, 4320), 3, spin=w)
		profile_roundtrips(750, (900, 1800))
		profile_roundtrips(2000, (2160, 4320))
		profile_roundtrips(750, (900, 1800), 1, spin=(0, 2))
		profile_roundtrips(2000, (2160, 4320), 1, spin=(0, 2))
		profile_roundtrips(750, (900, 1800), 1, spin=w)
		profile_roundtrips(2000, (2160, 4320), 1, spin=w)
		print("phase timing done at %.1f s" % (time.perf_counter() - t_start))
	if "variants" in phases:
		variants_phase()
		print("phase variants done at %.1f s" % (time.perf_counter() - t_start))
	if "blkprobe" in phases:
		blk_probe_phase()
		print("phase blkprobe done at %.1f s" % (time.perf_counter() - t_start))
	if set(phases) != set(PHASES):
		print("chip_smoke: phases %s only: no verdict" % phases)
		return 1
	for (name, mode, dt), rec in kernel_records.items():
		# launches of the record's kernel, mode and dtype by the path of that
		# mode: 0 for K3's and K4's float64 records, whose launches polar_synthesis and
		# polar_analysis took over
		rec["launches"] = launches[mode].get((name, dt), 0)
	for rec, path, bname in lstop_records.values():
		# the lmax-2000 launches: their count in that roundtrip
		rec["launches"] = launches[path].get((bname, "float32"), 0)
	for rec in records:   # K9: summed over every driven path
		rec["launches"] = sum(c["fma_peak"] for c in launches.values())
	records = list(kernel_records.values()) + [r[0] for r in lstop_records.values()] \
		+ list(blk_records.values()) + records
	print(card_line())
	print(json.dumps({"kernels": records}))
	print(json.dumps({"ok": True, "device": {"platform": "gpu",
		"kind": torch.cuda.get_device_name(0), "count": 1}}))
	return 0


if __name__ == "__main__":
	sys.exit(main())
