"""Smoke test of the PyTorch/CUDA port (pixell_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from pixell_tpu_torch/csrc with nvcc
(legendre.cu once per mode, blockleg.cu once per Legendre mode, fma_peak.cu
and nufft.cu, all compilers started together) and prints each kernel's
registers and spills (every float64 instantiation of the bulk kernels and
all twelve of K10 / K11 / K12 must be built, and none of them may spill),
then runs the phases below (all of them with no arguments; --phases with a
choice of k9,kernels,lstop,slice,adjoint,blocked,timing,general runs those
alone, for work on one phase, and gives no verdict; the phases
"variants", 6. below, and "blkprobe" run only when named). With
--parent DIR, a directory holding a parent tree's legendre.cu, blockleg.cu
and / or nufft.cu (for example unpacked with git archive under build/),
those files are built beside the package's: the kernels, variants and
timing phases run the parent's legendre.cu kernels beside this tree's, the
blocked phase its blk_synthesis_kernel, the general phase its unbinned
K10 / K11 (below):

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
   Every launch of K1-K4 in float64 runs bulk_synthesis_kernel<double> and
   bulk_analysis_kernel<double> (the float64 cases above). The float64
   rows: each at the shapes where the float64 paths launch it (f64_row_cases:
   K1 on the map's northern rings at lmax 750 and 2000, K2 on the 756
   northern upsampled rings at lmax 750, K4 on the first 2048-ring chunk of
   the 4032 upsampled rings and K3 on all 4032 at lmax 2000, K3 / K4 in
   wigner mode on 900 / 1512 rings at lmax 750), in every mode against the
   float64 plain version (1e-11 / 1e-10), at lmax 750 with 2 and with 4
   coefficient columns (every float64 instantiation), and in scalar and
   spin2 (wigner) with its time, the plain version's, the bound over the
   FP64 peak and beside it the bound with the accumulation on the FP64
   tensor cores (dmma_bound), the float64 torch.bmm yardstick and its
   launches per call of the float64 path (printed, "f64 row"); with
   --parent also the time of the float64 kernel the parent launched on the
   same input (its float64 bulk kernel, or before them its synthesis_kernel
   or analysis_kernel) and the two results' distance.
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
   launch per alm2map in its mode) and polar_analysis in float64, and
   K1-K4 in float64 never; its K1-K4 launches run the float32 entries
   (sht_cuda.BULK_KERNELS); every f64 roundtrip (spin 0, IQU, spin [0, 3]
   at lmax 750, spin 0 and IQU at lmax 2000) launches exactly the float64
   entries (sht_cuda.BULK_F64) the dispatch should give (f64_launches),
   and no other kernel;
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
     kernels' bound over the FP32 peak and beside it the tensor-core bound
     (both kernels put their products on the tensor cores in 3xTF32): the
     FP32 operations (the build) over the FP32 peak plus 3 x the products'
     FLOPs over 495 TFLOP/s (blk_tc_bound); with --parent, the parent's
     blk_synthesis_kernel on the same inputs, held to the same rule and
     timed in turns with this tree's; the library yardstick: torch.bmm
     over m of K3's / K4's mode table masked to each entry's blocked
     suffix (TF32 off), in chunks of 64 m rows with the times summed, its
     first chunk held
     within 1e-4 of the float64 plain block kernel resumed from the
     float64 state; before all that, every blk_synthesis_kernel and
     blk_analysis_kernel instantiation's registers and spills (ptxas -v),
     the count of tensor-core instructions (HMMA, HGMMA) in its SASS
     (cuobjdump -sass) and blk_synthesis_kernel's dynamic shared memory: a
     spill, a count of 0 or fewer than the 16 instantiations fails; and
     both kernels in every mode at C = 2 and 4 on a small case (lmax 335,
     16 m rows, 512 rings) against the float64 plain version, by the
     float32 rule above (blk_every_instantiation);
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
   within 1e-10 relative (alm inner product sum Re Re + Im Im), each
   float64 adjoint call launching only the float64 entries of K1-K4 (at
   lmax 2000 map2alm_adjoint K3's, on the 4032 upsampled rings); in float32
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
   busy share of the wall time; in float64 10 spin-0 and 10 IQU at lmax 750
   and 3 spin-0 at lmax 2000, each with its busy share from one profiled
   roundtrip and the alm after the roundtrips within 1e-10 of before (with
   --parent, twice, each time followed by the same with the parent's float64
   kernels).
6. variants (only with --phases variants): the bulk kernels' design
   choices measured. legendre.cu is copied under build/variants/ once per
   edit of BULK_VARIANTS (two or four rings a
   thread everywhere in the float32 bulk_analysis_kernel, one or two in
   its float64 instantiations and in bulk_synthesis_kernel in either type;
   the first group's test written gl0 == l8; north and mirror sums in the
   half-sky synthesis), each copy built (all started together) and its
   bulk kernels' registers and spills printed; at the main path's float32
   K1-K4 shapes each build's analysis result must lie within 1e-6 of the
   committed build's and its synthesis result within the float32 rule
   above (on the entries the main path keeps), at the float64 rows' shapes
   within 1e-12 of the committed build's, and its device time is printed
   beside the committed build's; with --parent the parent's kernels too,
   float32 within 1e-6 of the committed build's and float64 within 1e-10.
   Run it alone: late in a long process the profiler drops device events,
   and the times fall back to CUDA events.
7. general: the general-position method (the torus NUFFT) at lmax 2000,
   float64 and float32, each path driven with the launch counts at 0 just
   before and read just after (its Legendre launches those of its dtype,
   its point-stage kernel launched). First the SASS that K11's design
   rests on (nufft_sass_check: what atomicAdd on a shared float and double
   compiles to, from a probe; per K10 / K11 instantiation its shared and
   global atomics, shared loads and stores, and no shared atomics). K10
   (u2nu_points) and K11 (nu2u_spread, csrc/nufft.cu, the points binned by
   fine-grid tile with ops/nufft_core.py bin_points, whose result on the
   card must equal the CPU's) in all eight instantiations against their
   twins (1e-12 / 1e-5 of the largest value) on a small ragged case (C = 3,
   a 90 x 126 grid, w = 7 and 16) and on a pile-up (5000 of 6000 points in
   one place on a 256 x 256 grid, several subproblems of one tile; K11 in
   float32 there by the float32 rule below);
   synthesis_general of IQU at the 9,331,200 pixel centres of the
   2160x4320 F1 map displaced by 2.5 arcmin rms (from a seed), against a
   direct sum at 256 of them (each point the ring of its own theta through
   sht.synthesis_phase in float64, summed over m at its phi): 1e-9 / 5e-4;
   alm2map with method="general" on the undisplaced map against the 2d
   path in float64: the same bounds; adjoint_synthesis_general on the
   displaced points, <A x, y> = <x, A^T y> in float64 within 1e-10 and
   float32 against float64 within 5e-4; rotate_alm of spin 0 and IQU by
   the Galactic -> Equatorial Euler angles and back: float64 within 1e-9;
   K10 and K11 at the rotation's shape (16,020,006 points, an 8064^2 fine
   grid, w = 11 in float64, 7 in float32) and K11 at the adjoint's (IQU
   values, C = 3, at the 9,331,200 displaced points) against their twins
   (1e-12 / 1e-5; K11 in float32 by the float32 rule against the float64
   twin, its cells at the pulled-back poles summing ~10^4 contributions in
   the atomics' changing order), timed beside them with their bounds: the
   kernel's device time, the wrapper's with the points' bins cached and
   with the binning, the binning's alone; K12 (tile_keys) at the
   rotation's shape against its twin (equal keys), timed, with its bound;
   with --parent, the parent's unbinned K10 / K11 on the same inputs,
   timed in turns with this tree's ("old_ms"); then synthesis_general,
   adjoint_synthesis_general and rotate_alm (IQU and spin 0) timed with
   CUDA events after warm-up, at points whose bins are cached and at new
   points (the caches emptied before each call), each with its device
   busy share, launches by mode and dtype and peak memory. Every general
   path, driven with the bins' cache emptied just before, must bin
   through K12.

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
NUFFT_SOURCE = "pixell_tpu_torch/csrc/nufft.cu"
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
	# new kernels of the port: the reference's point stage runs in XLA, no pallas_call
	"u2nu_points": "pixell_tpu/fft.py:391",
	"nu2u_spread": "pixell_tpu/fft.py:610",
	# the binning's keys: each point's first tap from the split position, the split of
	# _u2nu_2d_core_split (the reference does not bin)
	"tile_keys": "pixell_tpu/fft.py:391",
}
MODES = ("scalar", "deriv", "spin1", "spin2", "wigner")   # in the build's order
WIGNER_SPIN = 3   # the spin the wigner mode is driven with
# NVIDIA H100 SXM data sheet: FP32 and FP64 outside the tensor cores, HBM3;
# dense TF32 and FP64 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
PEAK_DMMA = 67e12


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
	profiler's kernel names, demangled or not: bulk_analysis_kernel or
	bulk_synthesis_kernel in float32, bulk_analysis_kernel_f64 or
	bulk_synthesis_kernel_f64 in float64."""
	stem = name.split("_")[1]
	if dtype == torch.float32: return r"bulk_%s_kernel(<\d|ILi)" % stem
	return "bulk_%s_kernel_f64" % stem


def parent_pattern(name, lib):
	"""kernel_pattern of the float64 kernel the parent library lib
	(parent_library) launches for the wrapper name: its float64 bulk kernel
	where it has one, else synthesis_kernel or analysis_kernel, not the
	bulk_, polar_ or blk_ kernels of the same stem."""
	from pixell_tpu_torch.ops import sht_cuda
	entry = sht_cuda.BULK_F64[name]
	if lib.f64_entry[entry] == entry: return kernel_pattern(name, torch.float64)
	return r"(?<![A-Za-z_])%s_kernel" % name.split("_")[1]


def bound(ops, nbytes, dtype):
	"""(least time in ms, what bounds it): operations over the data-sheet
	peak for dtype, or bytes over the memory rate, whichever is larger."""
	t_ops, t_bytes = ops/PEAK_FLOPS[dtype], nbytes/PEAK_BYTES
	return 1e3*max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dmma_bound(name, mode, lmax, mmax, nt, C, nbytes):
	"""The least ms of a float64 kernel with its accumulation, a product
	batched over m, on the FP64 tensor cores: the recurrence and the mode
	functions over the FP64 peak plus the accumulation over PEAK_DMMA, or
	the bytes over the memory rate, whichever is larger."""
	other, acc = kernel_ops(name, mode, lmax, mmax, nt, C, split=True)
	return 1e3*max(other/PEAK_FLOPS[torch.float64] + acc/PEAK_DMMA, nbytes/PEAK_BYTES)


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
			f = re.search(r"fma_peak_kernelI([fd])", m.group(1))
			b = re.search(r"blk_(synthesis|analysis)_kernelILi(\d+)E", m.group(1))
			p = re.search(r"polar_(analysis|synthesis)_kernelILi(\d+)E", m.group(1))
			u = re.search(r"bulk_(analysis|synthesis)_kernel(_f64)?ILi(\d+)ELb([01])ELi(\d+)E(Lb([01])ELb"
				r"([01])E)?", m.group(1))
			n = re.search(r"(u2nu_points|nu2u_spread)_kernelI([fd])Lb([01])E", m.group(1))
			k = re.search(r"tile_keys_kernelI([fd])([si])E", m.group(1))
			entry = ("fma_peak<%s>" % f.group(1) if f else
				"%s<%s,%s>" % (n.group(1), n.group(2), "complex" if n.group(3) == "1" else "real") if n else
				"tile_keys<%s,%s>" % (k.group(1), "int16" if k.group(2) == "s" else "int32") if k else
				("blk_%s<C=%s>" % b.groups() if b else
				("polar_%s<d,C=%s>" % p.groups() if p else
				("bulk_%s%s<C=%s,%s,R=%s%s%s>" % (u.group(1), u.group(2) or "", u.group(3), "sym" if
				u.group(4) == "1" else "full", u.group(5), ",stops" if u.group(7) == "1" else "",
				",dump" if u.group(8) == "1" else "") if u else m.group(1)[:60]))))
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


# float64 instantiations of the bulk kernels (bulk_synthesis_kernel_f64,
# bulk_analysis_kernel_f64): each kernel in both forms at C = 2 and 4 in the
# four Legendre modes, in the full form in wigner mode
F64_INSTANTIATIONS = 2*(4*2*2 + 2)


def f64_build_check(rows):
	"""The float64 bulk kernels among print_build_summary's rows: all
	F64_INSTANTIATIONS of them, none spilling. Raises otherwise."""
	f64 = [r for r in rows if r[1].startswith("bulk_") and "_f64<" in r[1]]
	regs = [r[2] for r in f64] or [0]
	spilled = [r for r in f64 if r[3]]
	print("ptxas: %d float64 bulk instantiations (of %d), %d..%d registers, %d spilling%s" % (len(f64),
		F64_INSTANTIATIONS, min(regs), max(regs), len(spilled), "".join("; %s %s %d bytes" % (o, e, b)
		for o, e, _, b in spilled)))
	if len(f64) != F64_INSTANTIATIONS or spilled:
		raise RuntimeError("the float64 bulk kernels: %d instantiations built, %d spill"
			% (len(f64), len(spilled)))


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


def kernel_input(name, mode, lmax, mmax, nt, seed, C=None):
	"""Random input of kernel name in mode with C coefficient columns (by
	default ncoef's): independent north and south values, so a wrong
	hemisphere sign cannot cancel."""
	from pixell_tpu_torch.ops.sht_core import NFUN
	rng = np.random.default_rng(seed)
	nl, nm, nf, C = lmax + 1, mmax + 1, NFUN[mode], C or ncoef(mode)
	if name.endswith("synthesis"): shape = (nl, nm, C)
	elif name == "sym_analysis": shape = (nf, C, 2, nm, nt)
	else: shape = (nf, C, nm, nt)
	return rng.standard_normal(shape)


# operations per (l, m, theta) triple of the function (an FMA counts 2):
# the recurrence step and its unscaling, the mode functions (with
# lambda_{l-1}'s unscaling), and per coefficient column the accumulation,
# a multiply-add per function, in synthesis the sum over l, in analysis
# over theta (not counted: the half-sky synthesis's even-l and odd-l sums,
# which meet once per (m, ring), and the adds that combine the analysis
# kernels' per-thread partial sums, an artefact of how they split the sum
# over threads). The wigner mode steps a second
# branch with the offset's multiply-add on both (7 + 2*2) and combines the
# two into w and x (5). With dead-tile stops, only the triples of live
# blocks count: the others are not computed.
STEP_OPS = 7
MODE_OPS = {"scalar": 0, "deriv": 7, "spin1": 12, "spin2": 25, "wigner": 16}


def kernel_ops(name, mode, lmax, mmax, nt, C, dead=None, split=False):
	"""The operations of kernel name (either form of synthesis or
	analysis) in mode: their sum, or with split (recurrence and mode
	functions, accumulation)."""
	from pixell_tpu_torch.ops import sht_cuda
	from pixell_tpu_torch.ops.sht_core import NFUN
	rings = np.full(mmax + 1, nt) if dead is None else \
		sht_cuda.live_mask(dead, mmax + 1, nt).sum(1).cpu().numpy()
	first = np.maximum(np.arange(mmax + 1), mode_spin(mode) or 0)   # each row's seed degree
	triples = int((rings*np.maximum(lmax + 1 - first, 0)).sum())
	ops = (triples*(STEP_OPS + MODE_OPS[mode]), triples*2*C*NFUN[mode])
	return ops if split else sum(ops)


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


def kernel_phase(parent=None):
	"""The kernel phase (2. above); parent, the parent tree's library, or
	None. Returns (records of the lmax-750 cases, records of the float64
	rows)."""
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
			kname = (sht_cuda.BULK_KERNELS if main_dt == torch.float32 else sht_cuda.BULK_F64)[name]
			rec = {"name": "%s[%s]" % (kname, tag), "route": "cuda", "source": LEGENDRE_SOURCE,
				"replaces": REPLACES[name], "mode": mode,
				"max_abs_err": float((k.double() - ref).abs().max()),
				"ms": ms, "ms_from": how, "call_ms": cuda_ms(run, 20),
				"plain_ms": timed_once(lambda: plain(*args))[1],
				"bound_ms": b_ms, "bound_by": b_by,
				"library_ms": lib_ms, "library_rel_err": lib_err,
				"shape": "lmax %d, nm %d, nt %d, C %d, %s%s" % (lmax, mmax + 1, nt, C,
					str(main_dt)[6:], "" if dead is None else ", dead-tile table")}
			if main_dt == torch.float64:
				rec["bound_dmma_ms"] = dmma_bound(name, mode, lmax, mmax, nt, C,
					kernel_bytes(name, mode, lmax, mmax, nt, C, 8))
			if dead is not None:   # the same launch without the table
				rec["ms_without_dead_table"] = kernel_ms(lambda: kern(*args[:4]), 20,
					kernel_pattern(name, main_dt))[0]
			print("time   %-14s %-6s %s: kernel %.4f ms (%s; wrapper call %.4f ms%s), plain %.2f ms, "
				"bound %.4f ms (%s, %.1f %% of it reached%s), torch.bmm %.4f ms" % (name, mode,
				rec["shape"], rec["ms"], how, rec["call_ms"], "" if dead is None else
				"; without the table %.4f ms" % rec["ms_without_dead_table"], rec["plain_ms"], b_ms,
				b_by, 100*b_ms/rec["ms"], "" if dead is not None or main_dt == torch.float32 else
				"; with the accumulation on the FP64 tensor cores %.4f ms, %.1f %%" % (
				rec["bound_dmma_ms"], 100*rec["bound_dmma_ms"]/rec["ms"]), lib_ms))
			records[(kname, mode, str(main_dt)[6:])] = rec
			if label == "lmax750-polar":
				pname = "polar_" + name.split("_")[1]
				records[(pname, mode, "float64")] = polar_record(pname, mode, args, k, ref, rec)
		for pname in sht_cuda.POLAR_KERNELS: polar_shapes(pname, mode)
	return records, f64_rows(parent)


# the float64 paths whose launches the float64 rows report, by (wrapper,
# lmax) and mode: the roundtrips of the slice phase, and map2alm_adjoint for
# K3 at lmax 2000 (the adjoint phase)
F64_PATH_SPINS = {"scalar": "spin 0", "spin2": "IQU", "wigner": "spin [0, 3]"}


def f64_path(name, lmax, mode):
	"""The label of the float64 path (drive64) whose launches the row of
	name at lmax in mode reports."""
	if name == "full_synthesis" and lmax == 2000:
		return "f64 map2alm_adjoint %s lmax %d" % (F64_PATH_SPINS[mode], lmax)
	return "f64 %s lmax %d roundtrip" % (F64_PATH_SPINS[mode], lmax)


def f64_row_cases():
	"""[(wrapper, lmax, rings, (mode, C) held, modes timed)]: the shapes at
	which the float64 paths launch K1-K4 (no near-pole split in float64).
	K1 on the map's northern rings (900 x 1800 at lmax 750, 2160 x 4320 at
	lmax 2000); K2 on the northern 756 of the 1512 upsampled rings at lmax
	750; at lmax 2000 the 4032 upsampled rings are more than 2 SYM_MAX_NH,
	so K4 takes them in TCHUNK chunks (the first: 2048 rings) and
	map2alm_adjoint K3 on all of them; K3 / K4 in wigner mode (spin [0, 3])
	on the map's 900 and the 1512 upsampled rings at lmax 750. Every mode
	the path can give the kernel there is held, at lmax 750 at C = 2 and 4
	(the column chunks of the wrappers: every float64 instantiation), at
	lmax 2000 at ncoef's C; scalar and spin2 (wigner for the wigner rows)
	are timed, at ncoef's C."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	up = lambda lmax: sht.ring_theta("F1", fft.fft_len(2*lmax + 3, direction="above"))
	m750, m2000 = sht.ring_theta("F1", 900), sht.ring_theta("F1", 2160)
	timed = ("scalar", "spin2")
	both = lambda modes: [(mode, C) for mode in modes for C in (2, 4)]
	one = lambda modes: [(mode, ncoef(mode)) for mode in modes]
	return [
		("sym_synthesis", 750, m750[:sht_cuda.detect_sym(m750)], both(MODES[:4]), timed),
		("sym_analysis", 750, up(750)[:sht_cuda.detect_sym(up(750))], both(MODES[:4]), timed),
		("full_synthesis", 750, m750, both(MODES), ("wigner",)),
		("full_analysis", 750, up(750), both(MODES), ("wigner",)),
		("sym_synthesis", 2000, m2000[:sht_cuda.detect_sym(m2000)], one(MODES[:4]), timed),
		("full_analysis", 2000, up(2000)[:sht_cuda.TCHUNK], one(MODES), timed),
		("full_synthesis", 2000, up(2000), one(MODES), timed),
	]


def f64_rows(parent=None):
	"""The float64 kernels (bulk_synthesis_kernel<double>,
	bulk_analysis_kernel<double>) at the shapes of f64_row_cases: in every
	mode held there against the float64 plain version (1e-11 scalar, 1e-10
	the spin modes, of the largest value); in the timed modes also the
	kernel's time (profiler), the plain version's, the bound over the FP64
	peak and the float64 torch.bmm yardstick (at lmax 2000 over m in chunks
	of 64 rows); with parent, the parent tree's library (parent_library),
	the time of the kernel it launched on the same input and the two
	results' distance. Returns the timed rows' records by (wrapper, mode,
	lmax, rings); their launches are those of the float64 path f64_path
	names."""
	from pixell_tpu_torch.ops import sht_cuda
	dev, f64 = torch.device("cuda"), torch.float64
	records = {}
	for i, (name, lmax, theta, held, timed) in enumerate(f64_row_cases()):
		kern, plain, nt = getattr(sht_cuda, name), sht_cuda.PLAIN[name], len(theta)
		for mode, C in held:
			s = mode_spin(mode)
			x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt, 80 + i, C)).to(dev)
			g = sht_cuda.geom(theta, lmax, f64, dev, s)
			ref, plain_ms = timed_once(lambda: plain(x, g, lmax, mode))
			k = kern(x, g, lmax, mode)
			torch.cuda.synchronize()
			err, tol = relerr(k, ref), (1e-11 if mode == "scalar" else 1e-10)
			ok = err <= tol and bool(torch.isfinite(k).all()) and tuple(k.shape) == tuple(ref.shape)
			shape = "lmax %d, nm %d, nt %d, C %d, float64" % (lmax, lmax + 1, nt, C)
			print("f64 kernel %-14s %-6s %s: rel err %.3e (bound %.0e) %s" % (name, mode, shape, err, tol,
				"ok" if ok else "FAIL"))
			if not ok:
				raise RuntimeError("%s %s float64 at lmax %d, %d rings: the kernel disagrees with its "
					"plain version" % (name, mode, lmax, nt))
			if mode not in timed or C != ncoef(mode): continue
			run, n = (lambda: kern(x, g, lmax, mode)), (20 if lmax < 1000 else 5)
			ms, how = kernel_ms(run, n, kernel_pattern(name, f64))
			nbytes = kernel_bytes(name, mode, lmax, lmax, nt, C, 8)
			b_ms, b_by = bound(kernel_ops(name, mode, lmax, lmax, nt, C), nbytes, f64)
			dm_ms = dmma_bound(name, mode, lmax, lmax, nt, C, nbytes)
			if lmax < 1000:
				lib_ms, lib_err = library_ms(name, mode, x, theta, lmax, lmax, ref)
			else:
				lib_ms, lib_err = chunked_library_ms(name, mode, x, theta, lmax)
			if not lib_err <= 1e-10:
				raise RuntimeError("%s %s: the float64 yardstick computes another function" % (name, mode))
			entry = sht_cuda.BULK_F64[name]
			rec = {"name": "%s[%s, lmax %d, nt %d]" % (entry, mode, lmax, nt), "route": "cuda",
				"source": LEGENDRE_SOURCE, "replaces": REPLACES[name], "mode": mode,
				"max_abs_err": float((k - ref).abs().max()), "rel_err": err, "ms": ms, "ms_from": how,
				"call_ms": cuda_ms(run, n), "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
				"bound_dmma_ms": dm_ms, "library_ms": lib_ms, "library_rel_err": lib_err, "shape": shape,
				"path": f64_path(name, lmax, mode)}
			old = ""
			if parent is not None:
				with parent_kernels(parent):
					ko = kern(x, g, lmax, mode)
					torch.cuda.synchronize()
					rec["old_ms"], rec["old_ms_from"] = kernel_ms(run, n, parent_pattern(name, parent))
				rec["diff_to_old"] = relerr(k, ko)
				old = "; the parent's %s %.4f ms (%s; %.2fx), results %.3e apart" % (
					parent.f64_entry[entry], rec["old_ms"], rec["old_ms_from"], rec["old_ms"]/ms,
					rec["diff_to_old"])
			print("f64 row %-14s %-6s %s: %s %.4f ms (%s; wrapper call %.4f ms), plain %.2f ms, bound %.4f "
				"ms (%s, %.1f %% of it reached; with the accumulation on the FP64 tensor cores %.4f ms, "
				"%.1f %%), torch.bmm f64 %.4f ms (rel err %.3e)%s" % (name, mode, shape, entry, ms, how,
				rec["call_ms"], plain_ms, b_ms, b_by, 100*b_ms/ms, dm_ms, 100*dm_ms/ms, lib_ms, lib_err, old))
			records[(name, mode, lmax, nt)] = rec
			del x, k, ref
			torch.cuda.empty_cache()
	return records


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
		replaced_kernel="%s (bulk_%s_kernel<double,C,false>)" % (old["name"].split("[")[0],
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
	and K1-K4 in no mode in float64: the near-pole passes are
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
	k64 = {k: n for k, n in by_dtype.items() if k[0] in sht_cuda.BULK_F64.values()}
	if k64:
		raise RuntimeError("the %s path ran K1-K4 in float64 (%s), not polar_synthesis and "
			"polar_analysis" % (label, k64))
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


def f64_launches(lmax, nt_map, spin):
	"""{(kernel, mode, dtype): launches} of one float64 roundtrip (alm2map,
	map2alm, alm2map) of the spins spin on nt_map Fejer-1 rings, after the
	dispatch: no near-pole pass; each spin block's synthesis through K1 on
	the map's northern rings (K3 on all of them in wigner mode, or where
	they are more than 2 SYM_MAX_NH), its analysis through K2 on the
	northern upsampled rings (K4 in TCHUNK chunks in wigner mode, or where
	they are more than 2 SYM_MAX_NH); the float64 entries (BULK_F64) only."""
	from pixell_tpu_torch import fft
	from pixell_tpu_torch.ops import sht_cuda
	nt_up = fft.fft_len(2*lmax + 3, direction="above")
	want = {}
	for s in spin:
		mode = {0: "scalar", 1: "spin1", 2: "spin2"}.get(s, "wigner")
		half = lambda nt: mode != "wigner" and nt <= 2*sht_cuda.SYM_MAX_NH
		syn = "sym_synthesis" if half(nt_map) else "full_synthesis"
		ana, n = ("sym_analysis", 1) if half(nt_up) else ("full_analysis", -(-nt_up//sht_cuda.TCHUNK))
		want[(sht_cuda.BULK_F64[syn], mode, "float64")] = 2
		want[(sht_cuda.BULK_F64[ana], mode, "float64")] = n
	return want


def drive64(label, fn, want=None):
	"""Run the float64 path fn with every launch count set to 0 just before
	and read just after: it must launch, and only the float64 entries of
	K1-K4 (sht_cuda.BULK_F64); with want, {(kernel, mode, dtype): launches},
	exactly those. Returns (its launches by (kernel, mode, dtype), fn's
	result)."""
	from pixell_tpu_torch.ops import sht_cuda, fma_peak
	sht_cuda.reset_launches()
	fma_peak.LAUNCHES["fma_peak"] = 0
	out = fn()
	torch.cuda.synchronize()
	by_dtype = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	print("launches in the %s: %s" % (label, by_dtype))
	f64 = set(sht_cuda.BULK_F64.values())
	bad = {k: n for k, n in by_dtype.items() if not (k[0] in f64 and k[2] == "float64")}
	if not by_dtype or bad or fma_peak.LAUNCHES["fma_peak"] or (want is not None and by_dtype != want):
		raise RuntimeError("the %s launched %s; a float64 path launches the float64 entries of K1-K4 "
			"only%s" % (label, by_dtype, "" if want is None else ", here %s" % want))
	return by_dtype, out


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
	"""The slice phase (3. above). Returns (the float32 paths' launches by
	mode, the float64 paths' by label)."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	# at lmax 750 the float32 bulk takes K1/K2, the near-pole rings
	# polar_synthesis and polar_analysis in float64
	allk = ("sym_bulk_synthesis", "sym_bulk_analysis", "polar_synthesis", "polar_analysis")
	f32, f64 = torch.float32, torch.float64
	launches, launches64 = {}, {}
	def rt64(lmax, shape, spin):
		label = "f64 %s lmax %d roundtrip" % ({(0,): "spin 0", (0, 2): "IQU"}.get(spin, "spin %s"
			% list(spin)), lmax)
		launches64[label] = drive64(label, lambda: roundtrip(lmax, shape, f64, 1e-10, spin=spin),
			f64_launches(lmax, shape[0], spin))[0]
	counts, _ = drive("spin-0 lmax-750 f32 roundtrip", "scalar",
		lambda: roundtrip(750, (900, 1800), f32, 1e-4), allk)
	launches["scalar"] = counts
	rt64(750, (900, 1800), (0,))
	rt64(2000, (2160, 4320), (0,))
	rt64(2000, (2160, 4320), (0, 2))
	# more than 2*SYM_MAX_NH upsampled rings: the analysis runs K4, not K2
	counts, _ = drive("spin-0 lmax-2000 f32 roundtrip", "scalar",
		lambda: roundtrip(2000, (2160, 4320), f32, 5e-4),
		("sym_bulk_synthesis", "polar_synthesis", "full_bulk_analysis", "polar_analysis"))
	launches["scalar lmax 2000"] = counts
	counts, _ = drive("IQU lmax-750 f32 roundtrip", "spin2",
		lambda: roundtrip(750, (900, 1800), f32, 5e-4, spin=(0, 2)), allk)
	launches["spin2"] = counts
	rt64(750, (900, 1800), (0, 2))
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
	rt64(750, (900, 1800), (0, WIGNER_SPIN))
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
	return launches, launches64


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


def blk_tc_bound(name, mode, tab, lmax, nm, C):
	"""(least ms, FP32 operations, TF32 product FLOPs) of a block kernel
	with its products on the tensor cores in 3xTF32: the FP32 operations
	over the FP32 peak, plus three times the products' FLOPs over the dense
	TF32 peak. blk_synthesis: the build (the two chain steps, 6, and the
	folds, 4 NS C, per node and degree) in FP32; the node -> ring product
	of the 2 NS C fold rows and the four chain ends, 2 x rows x 128 x
	tile_t per m row and block, on the tensor cores. blk_analysis: the two
	chain steps in FP32; on the tensor cores, per m row and block the ring
	-> node contraction of the 2 NS C weighted fields and the chain-end
	product, 2 x rows x 128 x tile_t, and per m row and degree the node sums
	of the 2 x 128 chain values against the NS C columns, 2 x 256 x NS C."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	NS, JP = len(sht_core.BLK_FAM[mode]), sht_cuda.BLK_JP
	mdeg, mblk = blk_counts(tab, lmax, nm)
	prod = mblk*tab.tile_t*JP*2*(2*NS*C + 4)
	if name == "blk_synthesis":
		build = mdeg*JP*(6 + 4*NS*C)
	else:
		build = mdeg*JP*6
		prod += mdeg*2*2*JP*NS*C
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
	"""Registers and spills (ptxas -v) of every blk_synthesis_kernel and
	blk_analysis_kernel instantiation, the count of its tensor-core
	instructions (HMMA, HGMMA) in cuobjdump -sass of the built objects, and
	the synthesis kernel's dynamic shared memory. Raises on a spill, a count
	of 0 or a missing instantiation. Returns {(kernel, mode): [(C,
	registers, spill bytes, count), ...]} and {(mode, C): shared memory
	bytes of blk_synthesis_kernel}."""
	import ctypes
	from pixell_tpu_torch.ops import _build, sht_cuda
	d = _build.build_dir()
	rows = print_build_summary((d/"build.log").read_text(), only="blk_")
	tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
	counts = {}
	for k, mode in enumerate(MODES[:4]):
		r = subprocess.run([tool, "-sass", str(d/("blockleg.%d.o" % k))], capture_output=True,
			text=True, check=True)
		fn = None
		for line in r.stdout.splitlines():
			m = re.search(r"Function : (\S+)", line)
			if m:
				c = re.search(r"blk_(synthesis|analysis)_kernelILi(\d+)E", m.group(1))
				fn = ("blk_" + c.group(1), mode, int(c.group(2))) if c else None
				if fn: counts.setdefault(fn, 0)
			elif fn and re.search(r"\bHG?MMA\.", line):
				counts[fn] += 1
	out, smem = {}, {}
	lib = sht_cuda.library()
	for obj, entry, regs, spill in rows:
		c = int(re.search(r"C=(\d+)", entry).group(1))
		kernel, mode = entry.split("<")[0], obj.split(".")[1]
		n = counts.get((kernel, mode, c), 0)
		out.setdefault((kernel, mode), []).append((c, regs, spill, n))
		extra = ""
		if kernel == "blk_synthesis":
			fn = getattr(lib, "pt_blk_synthesis_smem_%s" % mode)
			fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
			smem[(mode, c)] = fn(c)
			extra = ", %d bytes of dynamic shared memory" % smem[(mode, c)]
		print("%s_kernel<C=%d> %s: %d registers, %d bytes spilled, %d tensor-core (HMMA/HGMMA) "
			"instructions in its SASS%s" % (kernel, c, mode, regs, spill, n, extra))
		if spill or not n:
			raise RuntimeError("%s_kernel<C=%d> %s: %d bytes spilled, %d HMMA/HGMMA" % (kernel, c, mode,
				spill, n))
		if kernel == "blk_synthesis" and regs != 65536//512:
			# its setmaxnreg split (PREGS, CREGS) assumes the whole register file at launch
			raise RuntimeError("blk_synthesis_kernel<C=%d> %s: %d registers a thread at launch, not %d" % (
				c, mode, regs, 65536//512))
	if len(rows) != 16 or len(counts) != 16:
		raise RuntimeError("blockleg.cu: %d ptxas entries and %d SASS functions of the block kernels, "
			"not 16" % (len(rows), len(counts)))
	return out, smem


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


def blk_every_instantiation():
	"""blk_synthesis and blk_analysis in every Legendre mode at C = 2 and 4
	(every instantiation, where the main shapes take one C a mode) on a
	small case: lmax 335, 16 m rows, two ring tiles of 256 mid-latitude
	rings starting at blocks 1 and 2, random alm or maps and a random O(1)
	state at levels 0 and -1; each within twice the float32 plain
	version's error against the float64 one, plus 2e-6."""
	from pixell_tpu_torch.ops import sht_cuda, sht_core
	dev = torch.device("cuda")
	LB = sht_cuda.BLK_LB
	lmax, mmax, nt = 3*LB - 1, 15, 2*sht_cuda.BLK_TILE_T
	theta = np.linspace(0.9, 2.2, nt)
	ctv, W = sht_cuda.blk_node_tables(theta, sht_cuda.BLK_TILE_T)
	start = np.array([[1, 2]]*(-(-(mmax + 1)//sht_cuda.BLK_TILE_M)), np.int32)
	f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
	tab = sht_core.BlkTables(f(start), f(ctv.astype(np.float32)), f(W.astype(np.float32)),
		sht_cuda.BLK_TILE_M, sht_cuda.BLK_TILE_T, f(sht_cuda.tf32_split(W)), f(sht_cuda.blk_w_fragments(W)))
	tab64 = sht_core.BlkTables(tab.start, f(ctv), f(W), tab.tile_m, tab.tile_t)
	g32 = sht_cuda.geom(theta, mmax, torch.float32, dev)
	g64 = sht_cuda.geom(theta, mmax, torch.float64, dev)
	for k, mode in enumerate(("scalar", "deriv", "spin1", "spin2")):
		for C in (2, 4):
			rng = np.random.default_rng(80 + 2*k + C)
			state = np.zeros((3, mmax + 1, nt), np.float32)
			state[:2] = rng.standard_normal((2, mmax + 1, nt))
			state[2] = -rng.integers(0, 2, (mmax + 1, nt))
			st = f(state)
			for name, shape in (("blk_synthesis", (lmax + 1, mmax + 1, C)),
					("blk_analysis", (sht_core.NFUN[mode], C, mmax + 1, nt))):
				x = f(rng.standard_normal(shape).astype(np.float32))
				k1 = getattr(sht_cuda, name)(x, st, tab, g32, lmax, mode)
				torch.cuda.synchronize()
				plain = sht_cuda.PLAIN[name]
				ref = plain(x.double(), st.double(), tab64, g64, lmax, mode)
				held("%s %s at C = %d, small case" % (name, mode, C), relerr(k1, ref),
					relerr(plain(x, st, tab, g32, lmax, mode), ref))


def blocked_kernels(mode, theta, records, parent=None):
	"""K3/K4 with the handoff and the block kernels in mode on the rings
	theta at BLK_LMAX, float32, against their plain versions and against
	the unsplit kernels; adds the block kernels' records. With parent, a
	parent library with blk_synthesis entries (parent_library), its
	blk_synthesis_kernel runs on the same inputs: held to the same rule and
	timed beside this tree's, in turns."""
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
		# the tensor-core bound beside the FP32 one
		tc_ms, build, prod = blk_tc_bound(blk.__name__, mode, tab, lmax, nm, C)
		rec["bound_tc_ms"] = max(tc_ms, 1e3*nbytes/PEAK_BYTES)
		tc = "; with the products in 3xTF32 on the tensor cores %.4f ms (%.3g FP32 operations of " \
			"the build, %.3g TF32 product FLOPs x 3; %.1f %% of it reached)" % (rec["bound_tc_ms"],
			build, prod, 100*rec["bound_tc_ms"]/ms_blk)
		if syn and parent is not None:
			rec.update(blk_parent_row(parent, mode, x32, kstate, tab, g32, lmax, k2, r2, p2, ms_blk))
		print("time   %-14s %-6s %s: kernel %.4f ms (%s), plain %.2f ms, FP32 bound %.4f ms (%s, %.1f %% "
			"of it reached)%s; torch.bmm of the masked mode table in chunks %.4f ms (rel err %.3e); %s "
			"with the handoff %.4f ms, to the end %.4f ms: the same suffix stepwise %.4f ms, split %.4f ms "
			"against unsplit %.4f ms" % (blk.__name__, mode, rec["shape"], ms_blk, how, plain_ms, b_ms, b_by,
			100*b_ms/ms_blk, tc, lib_ms, lib_err, name, ms_pre, ms_full, ms_full - ms_pre, ms_pre + ms_blk,
			ms_full))
		records[(blk.__name__, mode)] = rec


def blk_parent_row(lib, mode, x, state, tab, g, lmax, k2, r2, p2, ms_new):
	"""The parent's blk_synthesis_kernel (lib, parent_library) on the
	inputs this tree's ran on (x, state, tab with W as the parent reads
	it): held to the float32 rule against the float64 plain version r2 (p2
	the float32 plain version's result), then timed in turns with this
	tree's (ms_new its first time). Returns the record's parent keys."""
	from pixell_tpu_torch.ops import sht_cuda
	nl, nm, nt, C = lmax + 1, g.nm, g.nt, x.shape[-1]
	ab = sht_cuda._coef_cached(nl, nm, torch.float32, x.device)
	cs = sht_cuda._streams_cached(nl, nm, mode, x.device)
	out = torch.zeros_like(k2)
	fn = getattr(lib, "pt_blk_synthesis_%s" % mode)
	def old():
		err = fn(C, x.data_ptr(), ab.data_ptr(), cs.data_ptr(), state.data_ptr(), tab.start.data_ptr(),
			tab.ctv.data_ptr(), tab.W.data_ptr(), g.ct.data_ptr(), g.rows.data_ptr(), out.data_ptr(), nl,
			nm, nt, torch.cuda.current_stream().cuda_stream)
		if err: raise RuntimeError("the parent's blk_synthesis (%s) launch failed: CUDA error %d" % (mode, err))
	old()
	torch.cuda.synchronize()
	held("parent's blk_synthesis %s" % mode, relerr(out, r2), relerr(p2, r2))
	name = "blk_synthesis_kernel"
	new = lambda: sht_cuda.blk_synthesis(x, state, tab, g, lmax, mode)
	ms_old, how = kernel_ms(old, 5, name)
	ms_new2, _ = kernel_ms(new, 5, name)
	ms_old2, _ = kernel_ms(old, 5, name)
	print("time   blk_synthesis  %-6s this tree %.4f, %.4f ms; the parent's kernel %.4f, %.4f ms (%s; in turns: "
		"this, parent, this, parent): %.2fx" % (mode, ms_new, ms_new2, ms_old, ms_old2, how,
		(ms_old + ms_old2)/(ms_new + ms_new2)))
	return {"parent_ms": [ms_old, ms_old2], "ms_again": ms_new2, "parent_max_abs_err": float(
		(out.double() - r2).abs().max())}


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


def blocked_phase(parent=None):
	"""The blocked phase (4. above); parent, a parent library with
	blk_synthesis entries, or None."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	th_up = sht.ring_theta("F1", fft.fft_len(2*BLK_LMAX + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th_up, BLK_LMAX)
	theta = th_up[nn:len(th_up) - ns][:sht_cuda.TCHUNK]
	build, smem = blk_build_check()
	blk_every_instantiation()
	records = {}
	for mode in ("scalar", "deriv", "spin1", "spin2"):
		blocked_kernels(mode, theta, records, parent)
	launches = blocked_paths()
	for (name, mode), rec in records.items():
		rec["launches"] = launches.get((name, mode), 0)
		# (C, registers, spill bytes, tensor-core instructions)
		rec["ptxas_sass"] = build[(name, mode)]
		if name == "blk_synthesis":
			rec["smem_bytes"] = {c: smem[(mode, c)] for c in (2, 4)}
		if rec["launches"] == 0:
			raise RuntimeError("%s in %s mode was not launched by the blocked paths" % (name, mode))
	return records


# ---------------------------------------------------------------------------
# 5. timing
# ---------------------------------------------------------------------------
def roundtrip_step(lmax, shape, spin, dtype=torch.float32):
	"""arr -> alm2map(map2alm(arr)) at lmax on the full-sky F1 map, in
	dtype; also returns the map2alm of a map."""
	from pixell_tpu_torch import enmap, curvedsky
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	mshape = gshape if list(spin) == [0] else (3,) + gshape
	ainfo = curvedsky.alm_info(lmax=lmax)
	def analyse(arr):
		return curvedsky.map2alm(enmap.ndmap(arr, wcs), lmax=lmax, spin=list(spin))
	def step(arr):
		return curvedsky.alm2map(analyse(arr), enmap.zeros(mshape, wcs, dtype),
			spin=list(spin), ainfo=ainfo).data
	rng = np.random.default_rng(0)
	arr = torch.from_numpy(rng.standard_normal(mshape)).to("cuda", dtype)
	arr = step(step(arr))   # warmup; the result is band-limited
	torch.cuda.synchronize()
	return step, arr, analyse


def time_roundtrips(lmax, shape, nrep, spin=(0,), dtype=torch.float32, tag=""):
	"""nrep sequential roundtrips, timed with CUDA events (and the host
	clock) after warmup; checks the band-limited map comes back (float32:
	within 1e-3), in float64 its alm (within 1e-10), and prints the
	device's busy share of one profiled roundtrip. tag marks the lines."""
	step, arr, analyse = roundtrip_step(lmax, shape, spin, dtype)
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
	dt = str(dtype)[6:]
	print("timing%s: %d x lmax-%d spin %s %s roundtrip = %.3f ms (%.4f ms each; host clock "
		"%.3f ms); drift after %d roundtrips %.3e" % (tag, nrep, lmax, list(spin), dt, ms, ms/nrep,
		host*1e3, nrep, rel))
	if not rel < 1e-3: raise RuntimeError("timed roundtrips drifted: %g" % rel)
	if dtype == torch.float64:
		ealm = relerr(analyse(x), analyse(arr))
		wall, busy = profiled(lambda: step(arr), 10)
		print("timing%s: lmax-%d spin %s f64: alm after %d roundtrips rel err %.3e (bound 1e-10); one "
			"profiled roundtrip: wall %.3f ms, device busy %.3f ms (%.1f %%)" % (tag, lmax, list(spin),
			nrep, ealm, wall, busy, 100*busy/wall))
		if not ealm <= 1e-10: raise RuntimeError("the float64 roundtrips moved the alm by %g" % ealm)
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
	step, arr, _ = roundtrip_step(lmax, shape, spin)
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
# (its rings a thread: float32 four in the full scalar form, else two), of
# bulk_synthesis_kernel (its rings a thread: float32 two in scalar mode,
# else one; the half-sky form's even-l and odd-l sums, against north and
# mirror sums), of their float64 instantiations (rings a thread and the
# launch bounds' minimum of blocks an SM, which caps their registers:
# f64_analysis_rings .. f64_synthesis_blocks) or of both kernels (the way
# their first-group test is written). An edit applies wherever its text
# appears; the labels of edits that touch the float64 instantiations alone
# start with "f64".
F32_ANA = "constexpr int f32_analysis_rings(bool SYM) { return %s; }"
F32_SYN = "constexpr int f32_synthesis_rings() { return %s; }"
F64_ANA = "constexpr int f64_analysis_rings(int C) { return %s; }"
F64_ANA_B = "constexpr int f64_analysis_blocks(int C) { return %s; }"
F64_SYN = "constexpr int f64_synthesis_rings(int C) { return %s; }"
F64_SYN_B = "constexpr int f64_synthesis_blocks(int C) { return %s; }"
F64_SYN_RB = F64_SYN + "\n__host__ __device__ " + F64_SYN_B   # the two lines together
BULK_VARIANTS = {
	"R = 2": (F32_ANA % "MODE == SCALAR && !SYM ? 4 : 2", F32_ANA % "2"),
	"R = 4": (F32_ANA % "MODE == SCALAR && !SYM ? 4 : 2", F32_ANA % "4"),
	"gl0 == l8": ("else if (gl0 < l8 + BG)", "else if (gl0 == l8)"),
	"synthesis R = 1": (F32_SYN % "MODE == SCALAR ? 2 : 1", F32_SYN % "1"),
	"synthesis R = 2": (F32_SYN % "MODE == SCALAR ? 2 : 1", F32_SYN % "2"),
	"north/mirror sums": ("constexpr bool SYNTH_EVEN_ODD = true;", "constexpr bool SYNTH_EVEN_ODD = false;"),
	"f64 R = 1": (F64_ANA % "MODE == DERIV && C == 4 ? 1 : 2", F64_ANA % "1"),
	"f64 analysis 3 blocks": (F64_ANA_B % "MODE == DERIV && C == 2 ? 3 : 1", F64_ANA_B % "3"),
	"f64 analysis uncapped": (F64_ANA_B % "MODE == DERIV && C == 2 ? 3 : 1", F64_ANA_B % "1"),
	"f64 synthesis R = 2": (F64_SYN_RB % ("MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 2 : 1",
		"MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 1 : 2"), F64_SYN_RB % ("2", "1")),
	"f64 synthesis R = 1 at 2 blocks": (F64_SYN_RB % ("MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 2 : 1",
		"MODE == SCALAR || (MODE == SPIN1 && C == 4) ? 1 : 2"), F64_SYN_RB % ("MODE == SCALAR ? 2 : 1",
		"MODE == SCALAR ? 1 : 2")),
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


def parent_library(csrc):
	"""The kernel library built from a parent tree's legendre.cu and / or
	blockleg.cu and / or nufft.cu in the directory csrc (--parent), with
	the entry points that parent_kernels, blocked_kernels and parent_nufft
	call declared: the float32 bulk entries and the float64 ones the parent
	has, its blk_synthesis entries, its unbinned K10 / K11. lib.has_legendre,
	lib.has_blk and lib.has_nufft say which sources it held.
	lib.f64_entry maps each float64 bulk entry of this tree
	(sym_bulk_synthesis_f64, ...) to the parent's: the same, or in a parent
	that predates them the entry of synthesis_kernel / analysis_kernel
	named after the wrapper (sym_synthesis, ...)."""
	import ctypes
	from pathlib import Path
	from pixell_tpu_torch.ops import sht_core, sht_cuda, _build
	lib = _build.load(Path(csrc).resolve())
	lib.has_legendre = hasattr(lib, "pt_%s_scalar" % sht_cuda.BULK_KERNELS["sym_synthesis"])
	lib.has_blk = hasattr(lib, "pt_blk_synthesis_scalar")
	lib.has_nufft = hasattr(lib, "pt_u2nu_points")
	P, I = ctypes.c_void_p, ctypes.c_int
	if lib.has_nufft and not hasattr(lib, "pt_nufft_smem_bytes"):
		# the unbinned K10 / K11 of a parent before the binned ones: f64, complex, in, coords,
		# out, C, nfy, nfx, npt, pery, perx, w, beta, stream
		for fn in (lib.pt_u2nu_points, lib.pt_nu2u_spread):
			fn.argtypes = [I, I, P, P, P, I, I, I, ctypes.c_longlong, ctypes.c_double, ctypes.c_double, I,
				ctypes.c_double, P]
			fn.restype = I
	elif lib.has_nufft:
		print("--parent: its nufft.cu has the binned entry points; only the unbinned K10 / K11 of a parent "
			"before them are timed, so its K10 / K11 are not")
		lib.has_nufft = False
	for mode in sht_core.BLK_FAM if lib.has_blk else ():
		# C, 10 pointers, (nl, nm, nt), the stream
		fn = getattr(lib, "pt_blk_synthesis_%s" % mode)
		fn.argtypes, fn.restype = [I] + [P]*10 + [I]*3 + [P], I
	if not lib.has_legendre: return lib
	lib.f64_entry = {entry: entry if hasattr(lib, "pt_%s_scalar" % entry) else name
		for name, entry in sht_cuda.BULK_F64.items()}
	for mode in sht_core.MODES:
		for name in tuple(sht_cuda.BULK_KERNELS.values()) + tuple(lib.f64_entry.values()):
			if mode == "wigner" and name.startswith("sym"): continue
			fn = getattr(lib, "pt_%s_%s" % (name, mode))
			fn.argtypes = [I] + [P]*9 + [I]*(4 if "synthesis" in name else 5) + [P]*3
			fn.restype = I
	return lib


class parent_kernels:
	"""Within the block, sht_cuda's launches run the kernels of the parent
	library lib (parent_library), uncounted: a float32 launch the entry of
	the same name, a float64 one the parent's entry (lib.f64_entry)."""
	def __init__(self, lib): self.lib = lib
	def __enter__(self):
		from pixell_tpu_torch.ops import sht_cuda
		self.launch = sht_cuda._launch
		def launch(name, mode, device, f64, *args):
			with torch.cuda.device(device):
				err = getattr(self.lib, "pt_%s_%s" % (self.lib.f64_entry.get(name, name), mode))(*args)
			if err != 0:
				raise RuntimeError("the parent's %s (%s) launch failed: CUDA error %d" % (name, mode, err))
		sht_cuda._launch = launch
	def __exit__(self, *exc):
		from pixell_tpu_torch.ops import sht_cuda
		sht_cuda._launch = self.launch


def variants_phase(parent=None):
	"""The bulk kernels' design choices, measured: the sources built once
	per edit of BULK_VARIANTS (all builds started together), and each
	build's bulk kernels run at the main path's
	shapes, in float32 (K1 and K2 at lmax 750 in the four Legendre modes;
	K3 and K4 in wigner mode at lmax 750; K1 on the lmax-2000 map's northern
	rings and K4 on the first lmax-2000 chunk in scalar and spin2; K1, K3
	and K4 with the dead-tile table) and at the float64 rows' shapes
	(f64_row_cases: at lmax 750 in every mode the rows hold, at lmax 2000
	in the modes they time), its device time beside the committed build's.
	A float32 analysis result must lie within 1e-6 of the largest value of
	the committed build's. A float32 synthesis result is held, on
	the entries the float32 main path keeps (f32_kept), to the kernel
	phase's float32 rule against the float64 plain version: the variants
	sum in other orders (north and mirror sums, not even and odd ones), and
	in the spin modes the sums of one parity are larger than their total,
	so their rounding moves it by more than 1e-6. A float64 result must lie
	within 1e-12 of the committed build's. With parent, the parent tree's
	library (parent_library), its kernels run beside them: in float32 within
	1e-6 of the committed build's (the float32 instantiations compute what
	they computed), in float64 (its synthesis_kernel / analysis_kernel)
	within 1e-10. An edit labelled "f64" leaves the float32 code as it is,
	and skips the float32 cases."""
	from concurrent.futures import ThreadPoolExecutor
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda, _build
	dev = torch.device("cuda")
	builds = {label: variant_sources(label, old, new) for label, (old, new) in BULK_VARIANTS.items()}
	h0 = time.perf_counter()
	with ThreadPoolExecutor(max(len(builds), 1)) as ex:
		list(ex.map(sht_cuda.library, builds.values()))
	print("variants: %d builds in %.1f s" % (len(builds), time.perf_counter() - h0))
	for label, d in builds.items():
		print("variant %s:" % label)
		print_build_summary((_build.build_dir(d)/"build.log").read_text(), only="bulk_")
	runs = {"committed": lambda: use_library(_build.CSRC)}
	runs.update({label: (lambda d=d: use_library(d)) for label, d in builds.items()})
	if parent is not None: runs["parent"] = lambda: parent_kernels(parent)
	th = sht.ring_theta("F1", 1512)
	nn, ns = sht_cuda.polar_counts(th, 750)
	b750 = th[nn:len(th)-ns]
	th = sht.ring_theta("F1", fft.fft_len(2*2000 + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(th, 2000)
	b2000 = th[nn:len(th)-ns][:sht_cuda.TCHUNK]
	m750, m2000 = sht.ring_theta("F1", 900), sht.ring_theta("F1", 2160)
	legendre = ("scalar", "deriv", "spin1", "spin2")
	f32, f64 = torch.float32, torch.float64
	cases = [("sym_synthesis", mode, 750, m750[:450], f32) for mode in legendre] + [
		("sym_analysis", mode, 750, b750[:sht_cuda.detect_sym(b750)], f32) for mode in legendre] + [
		("full_synthesis", "wigner", 750, m750, f32), ("full_analysis", "wigner", 750, b750, f32),
		("sym_synthesis", "scalar", 2000, m2000[:1080], f32), ("full_analysis", "scalar", 2000, b2000, f32),
		("sym_synthesis", "spin2", 2000, m2000[:1080], f32), ("full_analysis", "spin2", 2000, b2000, f32)]
	cases += [(name, mode, lmax, theta, f64) for name, lmax, theta, held, timed in f64_row_cases()
		for mode, C in held if C == ncoef(mode) and (lmax < 1000 or mode in timed)]
	for i, (name, mode, lmax, theta, dt) in enumerate(cases):
		s = mode_spin(mode)
		x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, len(theta), 70 + i)).to(dev, dt)
		g = sht_cuda.geom(theta, lmax, dt, dev, s)
		args = (x, g, lmax, mode)
		if name != "sym_analysis" and dt == f32:
			args += (sht_cuda.dead_stops(theta, lmax, lmax, s or 0, dev),)
		kern = getattr(sht_cuda, name)
		syn = name.endswith("synthesis") and dt == f32
		if syn:   # the float32 rule on the kept entries
			kept = f32_kept(theta, lmax, lmax, dev, s)
			ref64 = sht_cuda.PLAIN[name](x.double(), sht_cuda.geom(theta, lmax, f64, dev, s),
				*args[2:])[..., kept]
			tol = 2*relerr(sht_cuda.PLAIN[name](*args)[..., kept], ref64) + 1e-6
		line, first = [], None
		n = 20 if lmax < 1000 else 5
		for label, context in runs.items():
			old = label == "parent"
			if dt == f32 and label.startswith("f64"): continue   # float32 code unchanged
			with context():
				out = kern(*args)
				torch.cuda.synchronize()
				ms, how = kernel_ms(lambda: kern(*args), n, parent_pattern(name, parent) if old and dt == f64
					else kernel_pattern(name, dt))
			first = out if first is None else first
			diff = relerr(out, first)
			if dt == f64: ok = diff <= (1e-10 if old else 1e-12)
			elif syn and not old: ok = relerr(out[..., kept], ref64) <= tol
			else: ok = diff <= 1e-6
			line.append("%s %.4f ms (%s), %.1e apart" % (label, ms, how, diff))
			if not ok:
				raise RuntimeError("variant %s of %s %s %s computes another function" % (label, name, mode,
					str(dt)[6:]))
			del out
		print("variant %s %s lmax %d, nt %d, %s: %s" % (name, mode, lmax, len(theta), str(dt)[6:],
			"; ".join(line)))
		del first, x
		torch.cuda.empty_cache()


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


# The same for blk_synthesis_kernel's two roles: thread 0 of the producers
# and thread 0 of the consumers each add the cycles since its point before
# to the phase of its points below (the first four the producer's, the
# rest the consumer's), from the role's start, waits included.
SYN_PROBES = (
	("producer: build", "    if (z + 1 < nz) put((z + 1) & 1);\n", False),
	("producer: tables, slab barrier", "    named_sync(BAR_PROD, SP);  // the next slab is in; this one is read\n",
		True),
	("producer: waiting for the consumers",
		"    if (z >= NZ) named_sync(BAR_EMPTY, SNT);  // the consumers have read the round before\n", True),
	("producer: hand-over", "    named_arrive(BAR_FULL, SNT);\n    reset();\n", True),
	("consumer: waiting for W", "  mbar_wait(wbar, 0);  // W is in\n", True),
	("consumer: waiting for the round", "      named_sync(BAR_FULL, SNT);  // the round's folds are in\n", True),
	("consumer: products", "        syn_product<N>(d, wf + i * KSTEPS * FRAG, fh, fl);\n", True),
	("consumer: epilogue", "#undef PT_D\n", True))


def syn_probed(text):
	"""blockleg.cu's text with blk_synthesis_kernel probed (SYN_PROBES) and
	the entry pt_blk_syn_probe_<mode>, which reads and clears the sums."""
	def put(text, at, new):
		if text.count(at) != 1: raise RuntimeError("synthesis probe: %r is not one place" % at)
		return text.replace(at, new)
	text = put(text, "  const int nz = S::PASSES * (nlb - first) * NZ;  // slabs in all\n",
		"  const int nz = S::PASSES * (nlb - first) * NZ;  // slabs in all\n  PT_SYN_START\n")
	text = put(text, "  mbar_wait(wbar, 0);  // W is in\n", "  PT_SYN_START\n  mbar_wait(wbar, 0);  // W is in\n")
	for i, (_, at, after) in enumerate(SYN_PROBES):
		probe = "PT_SYN(%d);\n" % (i % 4)
		text = put(text, at, at + probe if after else probe + at)
	# each role's sums, once, at its end
	text = put(text, "PT_SYN(3);\n  }\n}\n", "PT_SYN(3);\n  }\n  PT_SYN_FLUSH(p == 0, 0)\n}\n")
	text = put(text, "  }\n}\n\ntemplate <int C>\n__global__ void __launch_bounds__(SNT, 1)",
		"  }\n  PT_SYN_FLUSH(ct == 0, 4)\n}\n\ntemplate <int C>\n__global__ void __launch_bounds__(SNT, 1)")
	text = text.replace("namespace {\n", "namespace {\n__device__ unsigned long long pt_syn[8];\n"
		"#define PT_SYN_START unsigned long long pt_t = clock64(), pt_s[4] = {0, 0, 0, 0};\n"
		"#define PT_SYN(i) { const unsigned long long t = clock64(); pt_s[i] += t - pt_t; pt_t = t; }\n"
		"#define PT_SYN_FLUSH(lead, base) if (lead) for (int i = 0; i < 4; ++i) atomicAdd(&pt_syn[(base) + i], "
		"pt_s[i]);\n", 1)
	return text + '\nextern "C" int PT_ENTRY(pt_blk_syn_probe)(unsigned long long* out) {\n' \
		"  cudaMemcpyFromSymbol(out, pt_syn, sizeof(pt_syn));\n  unsigned long long zero[8] = {0};\n" \
		"  cudaMemcpyToSymbol(pt_syn, zero, sizeof(zero));\n  return (int)cudaGetLastError();\n}\n"


def blk_probe_sources():
	"""The kernel sources with blk_analysis_kernel probed (BLK_PROBES) and
	blk_synthesis_kernel probed (SYN_PROBES), in a directory of their own
	under build/."""
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
			text = syn_probed(text)
		(d/p.name).write_text(text)
	return d


def blk_probe_phase():
	"""blk_analysis and blk_synthesis at the blocked phase's shapes (lmax
	2000, the first 2048 bulk upsampled rings, from K4's or K3's handed-over
	state) in each mode from the probed build: the share of each phase in
	thread 0's cycles (blk_synthesis: in each role's, and its cycles per
	round), and the probed kernel's time (CUDA events; the probes cost a
	little)."""
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
	sbuf = (ctypes.c_ulonglong*8)()
	nlb = -(-(BLK_LMAX + 1)//sht_cuda.BLK_LB)
	for i, mode in enumerate(("scalar", "deriv", "spin1", "spin2")):
		read = getattr(lib, "pt_blk_syn_probe_%s" % mode)
		read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
		x = torch.from_numpy(kernel_input("full_synthesis", mode, BLK_LMAX, BLK_LMAX, len(theta),
			70 + i)).to(dev, torch.float32)
		C = x.shape[-1]
		# rounds of the 4 calls between the reads (cuda_ms warms up once)
		rounds = 4*int((nlb - tab.start.long()).clamp(min=0).sum())*(C//2)
		with use_library(d):
			_, state = sht_cuda.full_synthesis(x, g, BLK_LMAX, mode, lstop, True)
			fn = lambda: sht_cuda.blk_synthesis(x, state, tab, g, BLK_LMAX, mode)
			fn()
			torch.cuda.synchronize()
			read(sbuf)
			ms = cuda_ms(fn, 3)
			read(sbuf)
		for r, role in ((0, "producer"), (4, "consumer")):
			tot = sum(sbuf[r:r + 4])
			print("blkprobe blk_synthesis %s C=%d (probed build) %.4f ms per call; the %s's thread 0: %.0f cycles "
				"per round, by phase: %s" % (mode, C, ms, role, tot/rounds, ", ".join("%s %.1f %%" % (
				name.split(": ")[1], 100*c/tot) for (name, _, _), c in zip(SYN_PROBES[r:r + 4], sbuf[r:r + 4]))))


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
	launches of the float64 (drive64) and float32 adjoint calls, and the
	ring records of map2alm_adjoint's full_synthesis calls."""
	from pixell_tpu_torch import enmap, curvedsky
	b, m, wcs, spin, deriv = adjoint_inputs(lmax, shape, label, seed)
	ainfo = curvedsky.alm_info(lmax=lmax)
	f32, f64 = torch.float32, torch.float64
	zeros = lambda dt: enmap.zeros(tuple(m.shape), wcs, dt)
	launches = {}
	fwd = curvedsky.map2alm(enmap.ndmap(m, wcs), lmax=lmax, spin=spin, deriv=deriv)
	launches["map2alm_adjoint f64"], back = drive64("map2alm_adjoint %s lmax %d f64" % (label, lmax),
		lambda: curvedsky.map2alm_adjoint(b, zeros(f64), spin=spin, deriv=deriv).data)
	launches["alm2map_adjoint f64"], a_back = drive64("alm2map_adjoint %s lmax %d f64" % (label, lmax),
		lambda: curvedsky.alm2map_adjoint(enmap.ndmap(m, wcs), spin=spin, deriv=deriv, ainfo=ainfo))
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
	step, arr, _ = roundtrip_step(lmax, shape, spin)
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
	call by (cell, entry), and those of the float64 calls by path label
	(f64_path)."""
	from pixell_tpu_torch import fft
	out, launches64 = {}, {}
	def keep(launches, label, lmax):
		for entry, c in launches.items():
			out[("%s lmax %d" % (label, lmax), entry)] = c
			if entry.endswith("f64"):
				launches64["f64 %s %s lmax %d" % (entry.split()[0], label, lmax)] = c
	for i, label in enumerate(ADJ_CASES):
		keep(adjoint_cell(750, (900, 1800), label, 30 + i)[0], label, 750)
	nt_up = fft.fft_len(2*2000 + 3, direction="above")
	for i, label in enumerate(("spin 0", "IQU")):
		launches, rings, peak = adjoint_cell(2000, (2160, 4320), label, 40 + i)
		keep(launches, label, 2000)
		if not any(k[0] == "full_bulk_synthesis_f64" for k in launches["map2alm_adjoint f64"]):
			raise RuntimeError("map2alm_adjoint %s at lmax 2000 in float64 did not run K3's float64 entry"
				% label)
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
	return out, launches64


# ---------------------------------------------------------------------------
# 7. general: the torus NUFFT (K10, K11) and what runs on it
# ---------------------------------------------------------------------------
GEN_LMAX = 2000
GEN_SHAPE = (2160, 4320)       # the F1 map whose pixel centres are the points
GEN_DISP = 2.5/60*np.pi/180    # rms of the points' displacement (2.5 arcmin)
GEN_TOL = {torch.float64: 1e-9, torch.float32: 5e-4}   # of the largest value
GEN_ADJ_TOL = 1e-10            # adjointness, relative, f64
GEN_NREF = 256                 # points held against the direct sum
NUFFT_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # K10 / K11 against the twin
GEN_LAUNCHES = {}              # NUFFT launches of the general paths, by (name, dtype, kind)
# zyz Euler angles (psi, theta, phi) of the Galactic -> Equatorial rotation: the
# galactic north pole goes to (RA 192.85948, dec 27.12825 deg), the celestial
# pole lies at galactic longitude 122.93192 deg (J2000)
EULER_GAL2EQU = tuple(np.deg2rad([180 - 122.93192, 90 - 27.12825, 192.85948]))
ES_OPS = 8                     # operations counted per ES weight (sqrt, exp and six)
DEV = "cuda"


def nufft_build_check(rows):
	"""K10, K11 and K12 among print_build_summary's rows: u2nu_points and
	nu2u_spread, each in float and double, real and complex (8), and
	tile_keys in float and double, int16 and int32 keys (4), none spilling.
	Raises otherwise."""
	got = [r for r in rows if r[1].startswith(("u2nu_points<", "nu2u_spread<", "tile_keys<"))]
	print("ptxas: %d NUFFT instantiations (of 12): %s" % (len(got), ", ".join(
		"%s %d registers, %d bytes spilled" % (e, n, b) for _, e, n, b in got)))
	if len(got) != 12 or any(r[3] for r in got):
		raise RuntimeError("K10 / K11 / K12: %d instantiations built, %d spill" % (len(got),
			sum(bool(r[3]) for r in got)))


def nufft_ops(npt, C, w):
	"""Operations of one K10 or K11 call: per point and real component 2 w^2
	(a multiply-add per tap, FMA = 2), and 2 w ES weights of ES_OPS each."""
	return npt*(2*w*w*C + 2*w*ES_OPS)


def nufft_cells(coords, nfine, per, w, dtype):
	"""The fine-grid cells that the points' w x w windows reach, counted
	from this run's coordinates: each window's first row and column placed
	as nufft_core.taps places them (the fraction in dtype), then the marks
	widened by w along each axis with the periodic wrap. Points with
	colatitude in [0, pi] reach only about half of the torus's rows."""
	from pixell_tpu_torch.ops import nufft_core
	mark = torch.zeros(tuple(nfine), dtype=torch.bool, device=coords.device)
	first = [torch.remainder(b + torch.floor(f.to(dtype) - w/2).long() + 1, n) for (b, f), n in
		zip(nufft_core.split_positions(coords, nfine, per), nfine)]
	mark[first[0], first[1]] = True
	del first
	for ax in (0, 1):
		reach = mark.clone()
		for j in range(1, w): reach |= torch.roll(mark, j, ax)
		mark = reach
	return int(mark.sum())


def nufft_bytes(npt, C, ncells, esize):
	"""Bytes of one call: the ncells fine-grid cells the windows reach once
	(K10 reads them, K11 writes them; the zero fill of K11's grid is a
	separate memset outside the kernel's time), the float64 coordinates and
	the values once (C real components)."""
	return ncells*C*esize + npt*16 + npt*C*esize


def nufft_sass_check():
	"""What csrc/nufft.cu's K11 design rests on, read from cuobjdump -sass:
	the instructions that atomicAdd on a shared-memory float and double
	compiles to on this card's target (a probe built beside the library),
	and per K10 / K11 instantiation its shared-memory atomics (none
	expected: raises otherwise), global atomics, shared loads and stores."""
	from pixell_tpu_torch.ops import _build
	d = _build.build_dir()
	tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
	probe = d/"shared_atomic_probe.cu"
	probe.write_text("template <typename T> __global__ void shared_add(T* out, T v) {\n"
		"  __shared__ T s[64];\n  s[threadIdx.x] = T(0);\n  __syncthreads();\n"
		"  atomicAdd(&s[(threadIdx.x * 7) % 64], v);\n  __syncthreads();\n"
		"  out[threadIdx.x] = s[threadIdx.x];\n}\n"
		"template __global__ void shared_add<float>(float*, float);\n"
		"template __global__ void shared_add<double>(double*, double);\n")
	subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
		str(d/"shared_atomic_probe.cubin"), str(probe)], check=True, capture_output=True)
	for obj, what in ((d/"shared_atomic_probe.cubin", r"shared_add"), (d/"nufft.0.o",
			r"(u2nu_points|nu2u_spread)_kernel")):
		r = subprocess.run([tool, "-sass", str(obj)], capture_output=True, text=True, check=True)
		fn, ops = None, {}
		for line in r.stdout.splitlines():
			m = re.search(r"Function : (\S+)", line)
			if m:
				fn = m.group(1) if re.search(what, m.group(1)) else None
				if fn: ops[fn] = {}
				continue
			m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
			if fn and m:
				op = m.group(1)
				if op.startswith(("ATOMS", "ATOM", "RED", "LDS", "STS", "BSSY")):
					ops[fn][op] = ops[fn].get(op, 0) + 1
		for fn, o in ops.items():
			print("SASS %s: %s" % (fn, ", ".join("%s %d" % kv for kv in sorted(o.items())) or "none of "
				"ATOMS/ATOM/RED/LDS/STS"))
			if what != r"shared_add" and any(k.startswith("ATOMS") for k in o):
				raise RuntimeError("%s: shared-memory atomics in a NUFFT kernel" % fn)


def nufft_binning_agrees(co, nfine, per, w):
	"""The binning the wrappers do on the card against its plain version on
	the CPU, on the same points, in float32 and float64: K12's keys
	(tile_keys) equal to its twin's, and bin_points on them the same
	permutation and subproblems as the twin's bin_points."""
	from pixell_tpu_torch.ops import nufft_core, nufft_cuda
	for dt in (torch.float32, torch.float64):
		keys = nufft_cuda.tile_keys(co, nfine, per, w, dt, nufft_cuda.TILE)
		a = nufft_core.bin_points(co, nfine, per, w, dt, nufft_cuda.TILE, nufft_cuda.CAP, keys=keys)
		b = nufft_core.bin_points(co.cpu(), nfine, per, w, dt, nufft_cuda.TILE, nufft_cuda.CAP)
		if not (torch.equal(keys.cpu(), nufft_core.tile_keys(co.cpu(), nfine, per, w, dt, nufft_cuda.TILE))
				and torch.equal(a.perm.cpu(), b.perm) and torch.equal(a.subs.cpu(), b.subs)):
			raise RuntimeError("the binning on the card differs from the CPU's (%d points, %s)" % (
				co.shape[0], dt))
	print("K12 keys and bin_points on the card equal the CPU's: %d points, fine %dx%d, w %d, float32 and "
		"float64" % (co.shape[0], nfine[0], nfine[1], w))


def nufft_every_instantiation():
	"""K10 and K11 in every instantiation (float, double; real, complex)
	against their twins on the card, within NUFFT_TOL of the largest value:
	a small ragged case (C = 3, a 90 x 126 fine grid, smaller than a padded
	tile at w = 16, 3001 points, coordinates outside one period, w = 7 and
	16), and a pile-up (C = 3, a 256 x 256 grid, w = 11: 6000 points, 5000 of
	them within 0.01 fine pixels of one place, several subproblems of one
	tile). The binning on the card against the CPU's on both."""
	from pixell_tpu_torch.ops import nufft_cuda
	rng = np.random.default_rng(7)
	ragged = torch.from_numpy(np.stack([rng.uniform(-7, 13, 3001), rng.uniform(-5, 11, 3001)],
		-1)).to(DEV)
	pile = np.stack([rng.uniform(-7, 13, 6000), rng.uniform(-5, 11, 6000)], -1)
	pile[:5000] = [1.0, 2.0] + rng.uniform(0, 0.01/256, (5000, 2))*[2*np.pi, 5.0]
	pile = torch.from_numpy(pile).to(DEV)
	per = (2*np.pi, 5.0)
	nufft_binning_agrees(ragged, (90, 126), per, 16)
	nufft_binning_agrees(pile, (256, 256), per, 11)
	for dt in (torch.float32, torch.float64):
		for cplx in (False, True):
			for co, n, w, label in ((ragged, (90, 126), 7, "small case"), (ragged, (90, 126), 16,
					"small case"), (pile, (256, 256), 11, "pile-up")):
				f = torch.from_numpy(rng.standard_normal((3,) + n + (2,))).to(DEV, dt)
				f = torch.view_as_complex(f) if cplx else f[..., 0].contiguous()
				k = nufft_cuda.u2nu_points(f, co, per, w, 2.3*w)
				p = nufft_cuda.PLAIN["u2nu_points"](f, co, per, w, 2.3*w)
				ks = nufft_cuda.nu2u_spread(p, co, n, per, w, 2.3*w)
				ps = nufft_cuda.PLAIN["nu2u_spread"](p, co, n, per, w, 2.3*w)
				e = (relerr(k, p), relerr(ks, ps))
				rule = ""
				if dt == torch.float32 and label == "pile-up":
					# 5000 near-equal contributions to a cell, summed in f32 in two orders: K11 is
					# held to the float32 rule against the float64 twin
					p64 = nufft_cuda.PLAIN["nu2u_spread"](p.to(torch.complex128 if cplx else torch.float64),
						co, n, per, w, 2.3*w)
					e_k, e_p = relerr(ks, p64), relerr(ps, p64)
					rule = "; K11 against the float64 twin %.3e, the float32 twin's own %.3e (bound %.3e)" % (
						e_k, e_p, 2*e_p + 1e-6)
					e = (e[0], 0.0 if e_k <= 2*e_p + 1e-6 else np.inf)
				print("K10 / K11 %s %s w %d %s against the twins: %.3e / %.3e (bound %.0e)%s"
					% (str(dt)[6:], "complex" if cplx else "real", w, label, relerr(k, p), relerr(ks, ps),
					NUFFT_TOL[dt], rule))
				if not max(e) <= NUFFT_TOL[dt]:
					raise RuntimeError("K10 / K11 disagree with their twins on the %s" % label)


def parent_nufft(lib, name, x, coords, nfine, per, w, beta):
	"""The parent's unbinned K10 (name "u2nu_points") or K11 ("nu2u_spread")
	on the wrapper's arguments, uncounted: its output."""
	f64 = (x.real.dtype if x.is_complex() else x.dtype) == torch.float64
	out = x.new_empty((x.shape[0], coords.shape[0])) if name == "u2nu_points" else \
		x.new_zeros((x.shape[0], int(nfine[0]), int(nfine[1])))
	err = getattr(lib, "pt_" + name)(int(f64), int(x.is_complex()), x.data_ptr(), coords.data_ptr(),
		out.data_ptr(), x.shape[0], int(nfine[0]), int(nfine[1]), coords.shape[0], float(per[0]),
		float(per[1]), int(w), float(beta), torch.cuda.current_stream().cuda_stream)
	if err != 0:
		raise RuntimeError("the parent's %s launch failed: CUDA error %d" % (name, err))
	return out


def gen_drive(label, fn, kernels):
	"""Run the path fn with every launch count (sht_cuda's, nufft_cuda's)
	set to 0 just before and read just after. Its Legendre launches must be
	those of its dtype (float64: the float64 entries of K1-K4 only; float32:
	the float32 bulk kernels and the float64 near-pole passes), and each of
	kernels, (name, dtype, kind) of nufft_cuda, launched. Returns
	(Legendre launches, NUFFT launches, fn's result, peak device memory in
	GiB). The bins' cache is emptied before the run, and the binning's keys
	must come from K12 (tile_keys) in the same dtype."""
	from pixell_tpu_torch.ops import sht_cuda, nufft_cuda
	sht_cuda.reset_launches()
	nufft_cuda.reset_launches()
	nufft_cuda.clear_bins()
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	out = fn()
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	leg = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	nu = {k: n for k, n in nufft_cuda.LAUNCHES_BY_DTYPE.items() if n}
	for k, n in nu.items(): GEN_LAUNCHES[k] = GEN_LAUNCHES.get(k, 0) + n
	print("launches in the %s: Legendre %s, NUFFT %s (peak device memory %.2f GiB)" % (label, leg, nu,
		peak))
	f64 = kernels[0][1] == "float64"
	bulk = set((sht_cuda.BULK_F64 if f64 else sht_cuda.BULK_KERNELS).values())
	bad = {k: n for k, n in leg.items() if not ((k[0] in bulk and k[2] == kernels[0][1])
		or (not f64 and k[0] in sht_cuda.POLAR_KERNELS and k[2] == "float64"))}
	keys = any(k[0] == "tile_keys" and k[1] == kernels[0][1] for k in nu)
	if not leg or bad or any(not nu.get(k) for k in kernels) or not keys:
		raise RuntimeError("the %s launched Legendre %s, NUFFT %s: expected its dtype's kernels, %s and "
			"tile_keys" % (label, leg, nu, kernels))
	return leg, nu, out, peak


def gen_points(seed, displaced=True):
	"""(colat, phi) [npix, 2] float64 on the card: the pixel centres of the
	GEN_SHAPE F1 map, displaced by GEN_DISP rms (a Gaussian step in each of
	the two directions, the phi step over sin(theta)), folded back into
	[0, pi] across the poles."""
	from pixell_tpu_torch import enmap, curvedsky
	shape, wcs = enmap.fullsky_geometry(shape=GEN_SHAPE, variant="fejer1")
	loc = torch.from_numpy(curvedsky.calc_locinfo(shape, wcs).loc).to(DEV)
	if not displaced: return loc
	g = torch.Generator(device=DEV).manual_seed(seed)
	d = torch.randn(loc.shape, generator=g, device=DEV, dtype=torch.float64)*(GEN_DISP/np.sqrt(2))
	th = loc[:, 0] + d[:, 0]
	ph = loc[:, 1] + d[:, 1]/torch.sin(loc[:, 0])
	over = (th < 0) | (th > np.pi)
	th = torch.where(th < 0, -th, torch.where(th > np.pi, 2*np.pi - th, th))
	ph = torch.remainder(ph + np.pi*over, 2*np.pi)
	return torch.stack([th, ph], -1).contiguous()


def direct_sum(alm, loc, lmax, spin):
	"""alm [ncomp, nalm] (complex128) at loc [n, 2]: each point the one ring
	of its own theta through sht.synthesis_phase in float64 on the card,
	summed over m at its phi (m > 0 twice)."""
	from pixell_tpu_torch import sht
	order = torch.argsort(loc[:, 0])
	th = loc[order, 0].cpu().numpy()
	G = sht.synthesis_phase(alm, th, lmax, lmax, spin=spin)          # [ncomp, nm, n]
	m = torch.arange(lmax + 1, device=G.device, dtype=torch.float64)
	ph = torch.exp(1j*m[:, None]*loc[order, 1][None, :])
	eps = torch.where(m == 0, 1.0, 2.0)[:, None]
	vals = ((G*ph).real*eps).sum(-2)
	out = torch.empty_like(vals)
	out[..., order] = vals
	return out


def gen_alm(seed, spin, dtype=torch.complex128):
	from pixell_tpu_torch import curvedsky
	alm = curvedsky.rand_alm(spectrum(GEN_LMAX, spin), lmax=GEN_LMAX, seed=seed, device=DEV).to(dtype)
	return alm[0] if list(spin) == [0] else alm


def gen_synthesis(alm, loc, spin, label):
	"""synthesis_general of alm (f64) and of its f32 copy at loc, each path
	driven alone (gen_drive), held against the direct sum at GEN_NREF of the
	points. Returns {dtype: values}."""
	from pixell_tpu_torch import curvedsky
	rng = np.random.default_rng(11)
	sub = torch.from_numpy(rng.choice(loc.shape[0], GEN_NREF, replace=False)).to(DEV)
	ref = direct_sum(alm, loc[sub], GEN_LMAX, spin)
	out = {}
	for dt, a in ((torch.float64, alm), (torch.float32, alm.to(torch.complex64))):
		kind = ("u2nu_points", str(dt)[6:], "real")
		_, _, v, peak = gen_drive("synthesis_general %s lmax %d %s" % (label, GEN_LMAX, str(dt)[6:]),
			lambda: curvedsky.synthesis_general(a, loc, lmax=GEN_LMAX, spin=spin), [kind])
		if tuple(v.shape) != tuple(alm.shape[:-1]) + (loc.shape[0],) or not bool(torch.isfinite(v).all()):
			raise RuntimeError("synthesis_general %s: bad output %s" % (label, tuple(v.shape)))
		e = relerr(v[..., sub], ref)
		print("synthesis_general %s lmax %d %s at %d points (%d displaced by %.1f arcmin rms): against the "
			"direct sum at %d of them rel err %.3e (bound %.0e)" % (label, GEN_LMAX, str(dt)[6:],
			loc.shape[0], loc.shape[0], GEN_DISP/np.pi*180*60, GEN_NREF, e, GEN_TOL[dt]))
		if not e <= GEN_TOL[dt]:
			raise RuntimeError("synthesis_general %s %s outside its bound" % (label, str(dt)[6:]))
		out[dt] = v
	return out


def gen_undisplaced(alm, spin, label):
	"""alm2map with method="general" on the GEN_SHAPE F1 map (the
	undisplaced pixel centres) in f64 and f32, against alm2map on the 2d
	path in f64."""
	from pixell_tpu_torch import enmap, curvedsky
	shape, wcs = enmap.fullsky_geometry(shape=GEN_SHAPE, variant="fejer1")
	pre = tuple(alm.shape[:-1])
	ref = curvedsky.alm2map(alm, enmap.zeros(pre + shape, wcs, torch.float64), spin=spin).data
	for dt in (torch.float64, torch.float32):
		a = alm if dt == torch.float64 else alm.to(torch.complex64)
		kind = ("u2nu_points", str(dt)[6:], "real")
		_, _, m, _ = gen_drive("alm2map general %s %s" % (label, str(dt)[6:]), lambda: curvedsky.alm2map(
			a, enmap.zeros(pre + shape, wcs, dt), spin=spin, method="general").data, [kind])
		e = relerr(m, ref)
		print("alm2map method general %s lmax %d %s on the %dx%d F1 map against the 2d path in f64: rel err "
			"%.3e (bound %.0e)" % (label, GEN_LMAX, str(dt)[6:], shape[0], shape[1], e, GEN_TOL[dt]))
		if not e <= GEN_TOL[dt]:
			raise RuntimeError("alm2map general %s %s outside its bound" % (label, str(dt)[6:]))


def gen_adjoint(alm, loc, vals, spin, label):
	"""adjoint_synthesis_general at loc: <A x, y> = <x, A^T y> in f64 with x
	= alm, A x = vals, y a seeded random field, within GEN_ADJ_TOL; the f32
	adjoint against the f64 one within the f32 guard."""
	from pixell_tpu_torch import curvedsky
	g = torch.Generator(device=DEV).manual_seed(5)
	y = torch.randn(vals.shape, generator=g, device=DEV, dtype=torch.float64)
	out = {}
	for dt in (torch.float64, torch.float32):
		kind = ("nu2u_spread", str(dt)[6:], "real")
		_, _, out[dt], _ = gen_drive("adjoint_synthesis_general %s %s" % (label, str(dt)[6:]),
			lambda: curvedsky.adjoint_synthesis_general(y.to(dt), loc, lmax=GEN_LMAX, spin=spin), [kind])
	lhs, rhs = float((vals*y).sum()), alm_dot(alm, out[torch.float64])
	e32 = relerr(out[torch.float32], out[torch.float64])
	print("adjoint_synthesis_general %s lmax %d at %d points: <A x, y> %.15e, <x, A^T y> %.15e, rel diff "
		"%.3e (bound %.0e); f32 against f64 rel err %.3e (bound %.0e)" % (label, GEN_LMAX, loc.shape[0],
		lhs, rhs, abs(lhs - rhs)/abs(lhs), GEN_ADJ_TOL, e32, GEN_TOL[torch.float32]))
	if not (abs(lhs - rhs) <= GEN_ADJ_TOL*abs(lhs) and e32 <= GEN_TOL[torch.float32]):
		raise RuntimeError("adjoint_synthesis_general %s outside its bounds" % label)


def gen_rotate(alm, label):
	"""rotate_alm by EULER_GAL2EQU and back by the inverse angles: f64
	within GEN_TOL of the alm's largest value (and f32's error printed)."""
	from pixell_tpu_torch import curvedsky
	psi, theta, phi = EULER_GAL2EQU
	for dt, a in ((torch.float64, alm), (torch.float32, alm.to(torch.complex64))):
		kind = ("u2nu_points", str(dt)[6:], "real")
		_, _, r, _ = gen_drive("rotate_alm %s lmax %d %s" % (label, GEN_LMAX, str(dt)[6:]),
			lambda: curvedsky.rotate_alm(a, psi, theta, phi), [kind])
		back = curvedsky.rotate_alm(r, -phi, -theta, -psi)
		e = relerr(back, a)
		print("rotate_alm %s lmax %d %s: Galactic -> Equatorial and back, rel err %.3e%s" % (label, GEN_LMAX,
			str(dt)[6:], e, " (bound %.0e)" % GEN_TOL[dt] if dt == torch.float64 else ""))
		if dt == torch.float64 and not e <= GEN_TOL[dt]:
			raise RuntimeError("rotate_alm %s outside its bound" % label)


def nufft_row(name, dt, shape, x, loc, nfine, w, beta, plain, plain_ms, launches, parent=None,
		p64=None):
	"""One K10 / K11 record at the shape named shape: the wrapper name on x
	(K10 the fine grid, K11 the values) at loc (periods 2 pi) against the
	twin's output plain, within NUFFT_TOL; timed: the kernel's device time
	(profiler), the wrapper's (CUDA events; for K11 the zero fill with it)
	with the points' bins cached and with the bins' cache emptied before
	each call, and the binning's alone (K12's keys and bin_points on them,
	as the wrapper bins; CUDA events); its bound
	(nufft_ops, nufft_bytes of the cells nufft_cells counts). K11 in
	float32 is held to the float32 rule against the float64 twin's output
	p64 instead: the cells at the pulled-back poles sum ~10^4 contributions,
	whose float32 sums the twin and the kernel take in other orders. With
	parent (parent_library), the parent's unbinned kernel on the same
	inputs, timed in turns with this tree's (new, old, new, old), and the
	distance of the two results. Returns the record."""
	from pixell_tpu_torch.ops import nufft_core, nufft_cuda
	per = (2*np.pi, 2*np.pi)
	tag = str(dt)[6:]
	C = x.shape[0]
	if name == "u2nu_points": fn = lambda: nufft_cuda.u2nu_points(x, loc, per, w, beta)
	else: fn = lambda: nufft_cuda.nu2u_spread(x, loc, nfine, per, w, beta)
	k = fn()
	err = relerr(k, plain)
	f32_rule, rule = {}, "bound %.0e" % NUFFT_TOL[dt]
	if p64 is not None:
		e_k, e_p = relerr(k, p64), relerr(plain, p64)
		f32_rule = {"max_abs_err_vs_f64": e_k, "f32_twin_err_vs_f64": e_p, "err_bound": 2*e_p + 1e-6,
			"err_rule": "against the float64 twin within twice the float32 twin's own error plus 1e-6; "
			"max_abs_err (against the float32 twin) is not held to NUFFT_TOL"}
		rule = "against the float64 twin %.3e, the float32 twin's own %.3e (bound %.3e)" % (e_k, e_p,
			2*e_p + 1e-6)
		if not e_k <= 2*e_p + 1e-6:
			raise RuntimeError("%s float32 outside the float32 rule at %s" % (name, shape))
	elif not err <= NUFFT_TOL[dt]:
		raise RuntimeError("%s %s disagrees with its twin at %s" % (name, tag, shape))
	pattern = name + "_kernel"
	ms, how = kernel_ms(fn, 5, pattern)
	old, old_line = {}, ""
	if parent is not None:
		pfn = lambda: parent_nufft(parent, name, x, loc, nfine, per, w, beta)
		po = pfn()
		same = bool(torch.equal(k, po))
		d = relerr(k, po)
		o1 = kernel_ms(pfn, 5, pattern)
		n2 = kernel_ms(fn, 5, pattern)
		o2 = kernel_ms(pfn, 5, pattern)
		old = {"old_ms": o1[0], "old_ms_again": o2[0], "ms_again": n2[0], "old_ms_from": o1[1],
			"vs_old_rel_diff": d, "bit_identical_to_old": same}
		old_line = "; the parent's unbinned kernel %.4f, %.4f ms (this kernel again %.4f), results %s (rel diff " \
			"%.3e)" % (o1[0], o2[0], n2[0], "bit-identical" if same else "differ", d)
		del po
	del k
	wrapper_ms = cuda_ms(fn, 5)
	wrapper_bin_ms = cuda_ms(lambda: (nufft_cuda.clear_bins(), fn()), 5)
	bin_ms = cuda_ms(lambda: nufft_core.bin_points(loc, nfine, per, w, dt, nufft_cuda.TILE, nufft_cuda.CAP,
		keys=nufft_cuda.tile_keys(loc, nfine, per, w, dt, nufft_cuda.TILE)), 5)
	ncells = nufft_cells(loc, nfine, per, w, dt)
	esize = 8 if dt == torch.float64 else 4
	npt = loc.shape[0]
	b = bound(nufft_ops(npt, C, w), nufft_bytes(npt, C, ncells, esize), dt)
	n = launches.get((name, tag, "real"), 0)
	print("%s row %s %s: %d points, fine %dx%d (%d cells reached, %.1f %%), w %d, C %d real: kernel %.4f ms "
		"(%s), wrapper %.4f ms (CUDA events, bins cached; with the binning %.4f ms, the binning alone %.4f ms), "
		"rel err against the twin %.3e (%s), "
		"plain %.2f ms, bound %.4f ms (%s, %.1f %% of it reached)%s, launches in the general paths %d" % (
		"K10" if name == "u2nu_points" else "K11", tag, shape, npt, nfine[0], nfine[1], ncells,
		100*ncells/(nfine[0]*nfine[1]), w, C, ms, how, wrapper_ms, wrapper_bin_ms, bin_ms, err, rule, plain_ms,
		b[0], b[1], 100*b[0]/ms, old_line, n))
	return {"name": "%s[%s, %s]" % (name, tag, shape), "route": "cuda", "source": NUFFT_SOURCE,
		"replaces": REPLACES[name], "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
		"bound_ms": b[0], "bound_by": b[1], "library_ms": None, "ms_from": how, "wrapper_ms": wrapper_ms,
		"wrapper_bin_ms": wrapper_bin_ms, "bin_ms": bin_ms, **old, "shape": "npt %d, fine %dx%d (%d cells "
		"reached), w %d, C %d real" % (npt, nfine[0], nfine[1], ncells, w, C), **f32_rule}


def keys_row(dt, shape, loc, nfine, w, launches):
	"""The K12 record at the shape named shape: tile_keys on the card
	against its twin on the card (equal keys: max_abs_err 0), its device
	time (profiler), the twin's, and its bound: the coordinates read and
	the keys written over the memory rate, or ~20 operations a point (two
	axes of a division, three floors, four additions and subtractions, a
	product and a cast) over the dtype's peak."""
	from pixell_tpu_torch.ops import nufft_core, nufft_cuda
	per = (2*np.pi, 2*np.pi)
	tag = str(dt)[6:]
	fn = lambda: nufft_cuda.tile_keys(loc, nfine, per, w, dt, nufft_cuda.TILE)
	k = fn()
	p, plain_ms = timed_once(lambda: nufft_core.tile_keys(loc, nfine, per, w, dt, nufft_cuda.TILE))
	err = float((k.long() - p.long()).abs().max())
	if err != 0:
		raise RuntimeError("tile_keys %s disagrees with its twin at %s" % (tag, shape))
	ms, how = kernel_ms(fn, 5, "tile_keys_kernel")
	npt = loc.shape[0]
	b = bound(20*npt, npt*(16 + k.element_size()), dt)
	n = sum(c for key, c in launches.items() if key[0] == "tile_keys" and key[1] == tag)
	print("K12 row %s %s: %d points, fine %dx%d, %s keys: kernel %.4f ms (%s), equal to the twin, plain %.2f "
		"ms, bound %.4f ms (%s, %.1f %% of it reached), launches in the general paths %d" % (tag, shape, npt,
		nfine[0], nfine[1], str(k.dtype)[6:], ms, how, plain_ms, b[0], b[1], 100*b[0]/ms, n))
	return {"name": "tile_keys[%s, %s]" % (tag, shape), "route": "cuda", "source": NUFFT_SOURCE,
		"replaces": REPLACES["tile_keys"], "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
		"bound_ms": b[0], "bound_by": b[1], "library_ms": None, "ms_from": how,
		"shape": "npt %d, fine %dx%d, %s keys" % (npt, nfine[0], nfine[1], str(k.dtype)[6:])}


def gen_kernels(records, launches, parent=None):
	"""K10 and K11 at the shapes the general paths give them at lmax 2000,
	each a nufft_row record (with its launches in the general paths,
	launches by (name, dtype, kind)): at rotate_alm's, the 16,020,006
	pulled-back points of the 4003 x 4002 F1 grid on the 8064^2 real fine
	grid of a spin-0 SynthesisPlan (w = 11 in f64, 7 in f32), K11 spreading
	K10's output; and K11 at adjoint_synthesis_general's, IQU (C = 3) values
	from a seed at the 9,331,200 displaced points of gen_points on the
	fine grid of the 4032^2 torus (w = 11 in f64, 7 in f32: epsilon 1e-10 /
	1e-6). Before them, bin_points on the card against the CPU's on the
	first million of the rotation's points."""
	from pixell_tpu_torch import curvedsky, fft as enfft
	from pixell_tpu_torch.ops import nufft_cuda
	loc = curvedsky._rotated_grid(GEN_LMAX, EULER_GAL2EQU[1], DEV)[0]
	per = (2*np.pi, 2*np.pi)
	for dt in (torch.float64, torch.float32):
		plan = curvedsky.SynthesisPlan(gen_alm(21, (0,), torch.complex128 if dt == torch.float64 else
			torch.complex64), lmax=GEN_LMAX, spin=(0,))
		up = plan.uplan
		fine, nfine, w, beta = up.fine, up.nfine, up.w, up.beta
		del plan
		if dt == torch.float64: nufft_binning_agrees(loc[:10**6].contiguous(), nfine, per, w)
		records.append(keys_row(dt, "rotate_alm lmax %d" % GEN_LMAX, loc, nfine, w, launches))
		p, plain_ms = timed_once(lambda: nufft_cuda.PLAIN["u2nu_points"](fine, loc, per, w, beta))
		records.append(nufft_row("u2nu_points", dt, "rotate_alm lmax %d" % GEN_LMAX, fine, loc, nfine, w,
			beta, p, plain_ms, launches, parent))
		ps, plain_s_ms = timed_once(lambda: nufft_cuda.PLAIN["nu2u_spread"](p, loc, nfine, per, w, beta))
		p64 = None if dt == torch.float64 else nufft_cuda.PLAIN["nu2u_spread"](p.double(), loc, nfine, per,
			w, beta)
		del fine, up
		records.append(nufft_row("nu2u_spread", dt, "rotate_alm lmax %d" % GEN_LMAX, p, loc, nfine, w,
			beta, ps, plain_s_ms, launches, parent, p64))
		del p, ps, p64
		torch.cuda.empty_cache()
	del loc
	loc = gen_points(3)
	nfine = enfft._fine_shape(curvedsky._torus_shape(GEN_LMAX, GEN_LMAX))
	g = torch.Generator(device=DEV).manual_seed(5)
	y = torch.randn((3, loc.shape[0]), generator=g, device=DEV, dtype=torch.float64)
	for dt in (torch.float64, torch.float32):
		w, beta = enfft._es_params(1e-10 if dt == torch.float64 else 1e-6)
		v = y.to(dt)
		ps, plain_ms = timed_once(lambda: nufft_cuda.PLAIN["nu2u_spread"](v, loc, nfine, per, w, beta))
		p64 = None if dt == torch.float64 else nufft_cuda.PLAIN["nu2u_spread"](y, loc, nfine, per, w, beta)
		records.append(nufft_row("nu2u_spread", dt, "adjoint_synthesis_general IQU lmax %d" % GEN_LMAX, v,
			loc, nfine, w, beta, ps, plain_ms, launches, parent, p64))
		del ps, p64, v
		torch.cuda.empty_cache()


def gen_timing(label, fn, nrep):
	"""fn timed with CUDA events after warm-up (nrep calls), at its points
	with their bins (and rotate_alm's its grid) cached and again at new
	points: with those caches emptied before each call; its device busy
	share from one profiled call, its launches and peak memory (one driven
	call, the caches emptied before it)."""
	from pixell_tpu_torch import curvedsky
	from pixell_tpu_torch.ops import sht_cuda, nufft_cuda

	def cold():
		nufft_cuda.clear_bins()
		curvedsky._rotated_grid.cache_clear()
		return fn()
	sht_cuda.reset_launches()
	nufft_cuda.reset_launches()
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	cold()
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	modes = {k: n for k, n in sht_cuda.LAUNCHES_BY_MODE.items() if n}
	dts = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	nu = {k: n for k, n in nufft_cuda.LAUNCHES_BY_DTYPE.items() if n}
	ms = cuda_ms(fn, nrep)
	ms_cold = cuda_ms(cold, nrep)
	wall, busy = profiled(fn, 8)
	print("general timing: %s: %.4f ms per call (CUDA events, %d calls after warm-up, bins cached), %.4f ms "
		"at new points; device busy %.3f ms, %.1f %% of one profiled call (%.3f ms); peak device memory %.2f "
		"GiB; launches by mode %s, by dtype %s, NUFFT %s" % (label, ms, nrep, ms_cold, busy, 100*busy/wall,
		wall, peak, modes, dts, nu))


def general_phase(parent=None):
	"""The general method at lmax 2000 (GEN_LMAX), f64 and f32: K10 and K11
	in every instantiation on a small case; synthesis_general of IQU at the
	displaced pixel centres of the 2160 x 4320 F1 map (against the direct
	sum), alm2map with method="general" on the undisplaced map (against the
	2d path), adjoint_synthesis_general on the displaced points
	(adjointness, f32 against f64), rotate_alm of spin 0 and IQU (there and
	back); K10 / K11 at the rotation's shape against their twins, timed,
	with their bounds; then the end-to-end times. Returns the records of
	K10 and K11."""
	from pixell_tpu_torch import curvedsky
	nufft_sass_check()
	nufft_every_instantiation()
	GEN_LAUNCHES.clear()
	iqu = gen_alm(31, (0, 2))
	loc = gen_points(3)
	vals = gen_synthesis(iqu, loc, [0, 2], "IQU")
	gen_undisplaced(iqu, [0, 2], "IQU")
	gen_adjoint(iqu, loc, vals[torch.float64], [0, 2], "IQU")
	del vals
	gen_rotate(gen_alm(32, (0,)), "spin 0")
	gen_rotate(iqu, "IQU")
	torch.cuda.empty_cache()
	print("NUFFT launches in the general paths (each driven with the counts at 0): %s" % GEN_LAUNCHES)
	records = []
	gen_kernels(records, dict(GEN_LAUNCHES), parent)
	for r in records:
		if not r["launches"]:
			raise RuntimeError("%s: not launched by the general paths" % r["name"])
	psi, theta, phi = EULER_GAL2EQU
	y = torch.randn(iqu.shape[:-1] + (loc.shape[0],), device=DEV, dtype=torch.float64)
	for dt in (torch.float64, torch.float32):
		a, tag = (iqu, "f64") if dt == torch.float64 else (iqu.to(torch.complex64), "f32")
		yd = y.to(dt)
		gen_timing("synthesis_general IQU lmax %d %s, %d displaced points" % (GEN_LMAX, tag, loc.shape[0]),
			lambda: curvedsky.synthesis_general(a, loc, lmax=GEN_LMAX, spin=[0, 2]), 3)
		gen_timing("adjoint_synthesis_general IQU lmax %d %s, same points" % (GEN_LMAX, tag),
			lambda: curvedsky.adjoint_synthesis_general(yd, loc, lmax=GEN_LMAX, spin=[0, 2]), 3)
		gen_timing("rotate_alm IQU lmax %d %s" % (GEN_LMAX, tag),
			lambda: curvedsky.rotate_alm(a, psi, theta, phi), 3)
		gen_timing("rotate_alm spin 0 lmax %d %s" % (GEN_LMAX, tag),
			lambda: curvedsky.rotate_alm(a[0], psi, theta, phi), 3)
	return records


PHASES = ("k9", "kernels", "lstop", "slice", "adjoint", "blocked", "timing", "general")
EXTRA_PHASES = ("variants", "blkprobe")   # run only when named


def main():
	ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
	ap.add_argument("--phases", default=",".join(PHASES),
		help="comma-separated choice of %s (default: all but %s)" % (", ".join(PHASES + EXTRA_PHASES),
		", ".join(EXTRA_PHASES)))
	ap.add_argument("--parent", default=None, help="a directory holding a parent tree's legendre.cu, "
		"blockleg.cu and / or nufft.cu: the kernels phase times the float64 kernels it launched beside the "
		"float64 rows, the variants phase holds its float32 kernels against this tree's, the blocked phase "
		"times its blk_synthesis_kernel beside this tree's, and the general phase its unbinned K10 / K11")
	args = ap.parse_args()
	phases = args.phases.split(",")
	if not set(phases) <= set(PHASES + EXTRA_PHASES): ap.error("unknown phase in %s" % phases)
	if not torch.cuda.is_available():
		print("chip_smoke: no CUDA device", file=sys.stderr)
		return 2
	sys.path.insert(0, ROOT)
	from concurrent.futures import ThreadPoolExecutor
	from pixell_tpu_torch.ops import sht_cuda, _build
	t_start = time.perf_counter()
	print(card_line())
	print("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
		sys.version.split()[0]))
	torch.backends.cuda.matmul.allow_tf32 = False
	torch.backends.cudnn.allow_tf32 = False
	h0 = time.perf_counter()
	with ThreadPoolExecutor(2) as ex:   # the parent's build beside this tree's
		lib = ex.submit(sht_cuda.library)
		parent = None if args.parent is None else ex.submit(parent_library, args.parent)
		lib.result()
		parent = parent and parent.result()
	print("kernel build + load: %.1f s%s" % (time.perf_counter() - h0, "" if parent is None else
		" (with the parent's %s from %s)" % (" and ".join(f for f, has in (("legendre.cu",
		parent.has_legendre), ("blockleg.cu", parent.has_blk), ("nufft.cu", parent.has_nufft)) if has),
		args.parent)))
	# the parent's legendre.cu serves the kernels, timing and variants phases, its
	# blockleg.cu the blocked phase
	blk_parent = parent if parent is not None and parent.has_blk else None
	nufft_parent = parent if parent is not None and parent.has_nufft else None
	parent = parent if parent is not None and parent.has_legendre else None
	build_rows = print_build_summary((_build.build_dir()/"build.log").read_text())
	f64_build_check(build_rows)
	nufft_build_check(build_rows)
	records, kernel_records, f64_records, launches, launches64 = [], {}, {}, {}, {}
	blk_records, lstop_records, gen_records = {}, {}, []
	if "k9" in phases:
		records = fma_phase()
		print("phase K9 done at %.1f s" % (time.perf_counter() - t_start))
	if "kernels" in phases:
		kernel_records, f64_records = kernel_phase(parent)
		print("phase kernels done at %.1f s" % (time.perf_counter() - t_start))
	if "lstop" in phases:
		lstop_records = lstop_phase()
		print("phase lstop done at %.1f s" % (time.perf_counter() - t_start))
	if "slice" in phases:
		launches, launches64 = slice_phase()
		print("phase slice done at %.1f s" % (time.perf_counter() - t_start))
	if "adjoint" in phases:
		launches64.update(adjoint_phase()[1])
		print("phase adjoint done at %.1f s" % (time.perf_counter() - t_start))
	if "blocked" in phases:
		blk_records = blocked_phase(blk_parent)
		print("phase blocked done at %.1f s" % (time.perf_counter() - t_start))
	if "timing" in phases:
		w, f64 = (0, WIGNER_SPIN), torch.float64
		time_roundtrips(750, (900, 1800), 40)
		time_roundtrips(2000, (2160, 4320), 5)
		time_roundtrips(750, (900, 1800), 10, spin=(0, 2))
		time_roundtrips(2000, (2160, 4320), 3, spin=(0, 2))
		time_roundtrips(750, (900, 1800), 10, spin=w)
		time_roundtrips(2000, (2160, 4320), 3, spin=w)
		for lmax, shape, nrep, spin in ((750, (900, 1800), 10, (0,)), (750, (900, 1800), 10, (0, 2)),
				(2000, (2160, 4320), 3, (0,))):
			# with a parent, its float64 kernels on the same roundtrips, in turns
			for turn in range(1 if parent is None else 2):
				time_roundtrips(lmax, shape, nrep, spin, f64)
				if parent is not None:
					with parent_kernels(parent):
						time_roundtrips(lmax, shape, nrep, spin, f64, " (the parent's kernels)")
		profile_roundtrips(750, (900, 1800))
		profile_roundtrips(2000, (2160, 4320))
		profile_roundtrips(750, (900, 1800), 1, spin=(0, 2))
		profile_roundtrips(2000, (2160, 4320), 1, spin=(0, 2))
		profile_roundtrips(750, (900, 1800), 1, spin=w)
		profile_roundtrips(2000, (2160, 4320), 1, spin=w)
		print("phase timing done at %.1f s" % (time.perf_counter() - t_start))
	if "general" in phases:
		gen_records = general_phase(nufft_parent)
		print("phase general done at %.1f s" % (time.perf_counter() - t_start))
	if "variants" in phases:
		variants_phase(parent)
		print("phase variants done at %.1f s" % (time.perf_counter() - t_start))
	if "blkprobe" in phases:
		blk_probe_phase()
		print("phase blkprobe done at %.1f s" % (time.perf_counter() - t_start))
	# the float64 rows' launches: their kernel's in mode by the float64 path
	# they report (f64_path)
	for (name, mode, lmax, nt), rec in f64_records.items():
		c = launches64.get(rec["path"])
		rec["launches"] = None if c is None else c.get((sht_cuda.BULK_F64[name], mode, "float64"), 0)
		print("f64 row %s: launches per call of the %s: %s" % (rec["name"], rec["path"],
			"not driven" if c is None else rec["launches"]))
		if c is not None and not rec["launches"]:
			raise RuntimeError("%s: not launched by the %s" % (rec["name"], rec["path"]))
	if set(phases) != set(PHASES):
		print("chip_smoke: phases %s only: no verdict" % phases)
		return 1
	for (name, mode, dt), rec in kernel_records.items():
		# launches of the record's kernel, mode and dtype by the float32 path
		# of that mode: 0 for the float64 near-pole records, whose launches
		# polar_synthesis and polar_analysis took over on that path
		rec["launches"] = launches[mode].get((name, dt), 0)
	for rec, path, bname in lstop_records.values():
		# the lmax-2000 launches: their count in that roundtrip
		rec["launches"] = launches[path].get((bname, "float32"), 0)
	for rec in records:   # K9: summed over every driven path
		rec["launches"] = sum(c["fma_peak"] for c in launches.values())
	records = list(kernel_records.values()) + list(f64_records.values()) \
		+ [r[0] for r in lstop_records.values()] + list(blk_records.values()) + gen_records + records
	print(card_line())
	print(json.dumps({"kernels": records}))
	print(json.dumps({"ok": True, "device": {"platform": "gpu",
		"kind": torch.cuda.get_device_name(0), "count": 1}}))
	return 0


if __name__ == "__main__":
	sys.exit(main())
