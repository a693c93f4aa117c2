"""Smoke test of the PyTorch/CUDA port (pixell_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from pixell_tpu_torch/csrc with nvcc
(legendre.cu once per mode, blockleg.cu once per Legendre mode, fma_peak.cu
and nufft.cu, all compilers started together; beside them, with g++, the
native FITS reader pixell_tpu_torch/cpp/fitsio_core.cpp when the io phase
runs) and prints each kernel's
registers and spills (every float64 instantiation of the bulk kernels and
all twelve of K10 / K11 / K12 and the ten of K13 / K14 must be built, and
none of them may spill),
then runs the phases below (all of them with no arguments; --phases with a
choice of k9,kernels,lstop,slice,adjoint,blocked,timing,general,flat,interp,healpix,lensing,config5,
analysis,mesh,io,plot,utils runs
those alone, for work on one phase, and gives no verdict; the phases
"variants", 6. below, and "blkprobe" run only when named). With
--parent DIR, a directory holding a parent tree's legendre.cu, blockleg.cu
and / or nufft.cu (for example unpacked with git archive under build/),
those files are built beside the package's (a parent's legendre.cu must
take the m block's first m, as this tree's does): the kernels, variants and
timing phases run the parent's legendre.cu kernels beside this tree's, the
blocked phase its blk_synthesis_kernel, the general phase its unbinned K10
/ K11 (below):

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
   limits, a ragged m count and two launches into one output; and, in the
   modes of the lmax-2000 paths (scalar, deriv, spin2, wigner), at their
   near-pole shapes (the 2160-ring map's near-pole
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
   wigner mode on 900 / 1512 rings at lmax 750) against the float64 plain
   version (1e-11 / 1e-10), at lmax 750 in every mode with 2 and with 4
   coefficient columns (every float64 instantiation), at lmax 2000 in the
   timed modes, and in scalar and
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
   spin2 and wigner mode, the second in scalar), each launched
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
8. flat: the flat-sky path, which runs on torch.fft (cuFFT) and plain
   torch passes, no hand-written kernel (the reference has no pallas_call
   there). BASELINE config 1 (scripts/benchmark_baseline.py:58-77): a
   256 x 512 CAR T map, enmap.fft -> calc_ps2d -> a 64-bin spectrum over
   modlmap -> enmap.ifft(...).real, in float32 and float64, timed with
   CUDA events (100 steps a repeat, median, min and max of 7 repeats) with
   the busy share of one profiled repeat; ifft(fft) within 1e-5 / 1e-12
   of the input and the float64 spectrum within 1e-12 of the same call on
   CPU tensors. An ACT DR6-sized band (band_geometry of dec -63 .. 23
   degrees at 0.5 arcmin, 10320 x 43200): IQU float32 white noise from a
   seeded torch.Generator on the card through map2harm(normalize="phys",
   spin=[0, 2]) -> lbin(calc_ps2d) -> harm2map, and T float64 through fft
   -> lbin -> ifft: the step's ms (median, min, max of 7) and each
   stage's, the busy share and top device ops of one profiled step, the
   memory peak (under 70 GiB), the plain rotation's and the binning's time
   against their bytes bound over 3.35 TB/s; harm2map(map2harm) within
   1e-5 / 1e-12 of the input, the binned spectrum within 1e-6 of numpy's
   bincount of the same |F|^2 (its first component, copied to the host once,
   outside the timing), and no host <-> device copy above 1 MB in the
   profiled step.
   rand_map of IQU at 1024 x 2048 in float64 on the card and on CPU
   tensors from one seed within 1e-12. With --phases flat alone the
   hand-written kernels are not built.
9. interp: the pixel side (interpol, resample, enmap's project / at /
   cut-outs / resolution changes), plain torch, no hand-written kernel (the
   reference has no pallas_call there). Guards first, on a 1024 x 2048 CAR
   map from a numpy seed: project onto a CEA geometry, at 100000 positions,
   the transpose and deriv=True of map_coordinates there, downgrade 2 and a
   submap, each on the card against the same call on CPU tensors (1e-12 in
   float64, 2e-5 in float32), and <A x, y> = <x, A^T y> of map_coordinates
   in float64 within 1e-12. Then on the DR6-sized band of the flat phase
   (white noise from a seeded torch.Generator): project of T float64 and
   IQU float32 onto the CEA geometry of its footprint at 0.5 arcmin
   (8813 x 43200), order 3, border "constant": the ms (median, min, max of
   7), the stages positions / prefilter / gather (median of 3) each against
   its bytes bound over 3.35 TB/s, the busy share of one profiled call and
   its host <-> device copies (none above 1 MB: both geometries are
   separable, so only the two axes are copied), the memory peak (under 70
   GiB), and the order-3 spline at 4 000 000 pixel centres within 1e-12 /
   1e-5 of the largest value; at of the IQU float32 band at 4 000 000
   positions drawn uniformly in it (order 3 and 1) with its stages and busy
   share, and the transpose and deriv=True of map_coordinates at the same
   points; downgrade 2, upgrade 2, resample 0.5 (fft) and apod 120 against
   their bytes bounds; a 20 x 20 degree submap across RA = 180 inserted
   back into zeros, the roundtrip exact. With --phases interp alone (or with
   flat) the hand-written kernels are not built.
10. healpix: BASELINE config 3 (IQU SHT + CAR -> HEALPix,
   scripts/benchmark_baseline.py:100-121) and thumbnails, through
   pixell_tpu_torch.reproject: the Legendre stages on K1-K4 and their
   near-pole passes, the general method on K10 / K11, the ring pixels and
   the cap gather in plain torch. Guards first, IQU at nside 64 and lmax
   128 from a numpy seed: alm2map_healpix (ring and general),
   map2alm_healpix (niter 0 and 2, and general), healpix2map and
   map2healpix in both methods and thumbnails of 3 objects, each on the
   card against the same call on CPU tensors in float64 (1e-12 of the
   largest value), and in float32 each side against that float64 result:
   the card's error within twice the CPU's plus 2e-5 (the card's float32
   Legendre stages and the CPU's plain float32 scan are two float32
   algorithms); ring against general (1e-9 / 2e-4);
   <A x, y> = <x, A^T y> of the ring synthesis in float64 (1e-10); and
   map2healpix(rot="gal,equ", method="harm")'s I against synthesis_general
   at the centres transformed by coordinates.transform (1e-9, float64).
   Then config 3 in float32 and float64: map2alm of a seeded 3 x 2002 x 4004
   white-noise Fejer-1 map at lmax 2000, alm2map_healpix at nside 1024
   (12,582,912 pixels: a belt of 2049 rings x 4096, caps of 4,190,208), and
   alm2map back; the alm roundtrip (2e-3 / 1e-10), ring against general at
   full size (2e-3 / 1e-9, the lmax-2000 float32 IQU bound), the step's ms (median, min, max of 7), its stages (median of
   3: map2alm, the HEALPix Legendre stage, belt and caps, alm2map), the cap
   gather and its index_add_ transpose against their bytes bounds over
   3.35 TB/s and as shares of the step, the busy share and top ops of one
   profiled step (no host <-> device copy above 1 MB), its Legendre
   launches (each path driven with the counts at 0 just before and read
   just after; its kernels must have launched) and the memory peak (under
   70 GiB). At nside 1024 and lmax 2000 in both dtypes: the ring and the
   general synthesis timed, map2alm_healpix with niter 0 and 3,
   healpix2map ("harm", onto 2002 x 4004) and map2healpix ("spline",
   boundary="wrap"). thumbnails of the IQU float32 DR6-sized band (the
   flat phase's) around 10 000 objects drawn uniformly in it (r 10', res
   0.5', order 3, with polarization): ms (median of 3), the stages
   positions, prefilter, gather and rotation, busy share; and 5 objects of
   a 4-degree strip in float64 batched against one call each (1e-12). The
   kernels JSON line gives each kernel's launches in these paths
   ("healpix_launches").
11. lensing: BASELINE config 4 (curved-sky lensing, then Doppler
   aberration, scripts/benchmark_baseline.py:124-169) through
   pixell_tpu_torch.lensing and .aberration: the gradient SHT and the
   torus synthesis on K1-K4 (and in float32 their near-pole passes), the
   point stage on K12 and K10 in dec bands, the positions and offsets, the
   rotations, the spline interpolation and the modulation in plain torch.
   Guards first, on a 40 x 40 CAR patch at 0.5 degrees, lmax 64, IQU,
   inputs from a numpy seed: lens_map_curved (output "lupka", unbanded and
   in bands of 4 degrees), lens_map_flat, delens_map, boost_map (thermo,
   dipole), fft.shift_interp, inufft, nufft_adjoint and iu2nu (300 points,
   an 8 x 10 grid, the grid back within 1e-5), each on the card against the
   same call on CPU tensors, float64 within 1e-12 of the largest value
   (the lensed map within 1e-11: the fine grid's deconvolution magnifies
   the devices' torus differences), float32 each side against the CPU's
   float64 result (the card within twice the CPU's error plus 2e-5). Then config 4 in float32 and float64:
   the 1200 x 2400 CAR patch (box [[-5, 10], [5, -10]] degrees at 0.5
   arcmin), IQU alm at lmax 4000 from lensing.rand_alm(seed=1) resident on
   the card, lens_map_curved(delta_theta=2 degrees) then
   boost_map(modulation=None): the step's ms (median, min, max of 7), its
   stages (median of 3: gradient SHT, plan build and its torus synthesis,
   the band loop with its positions, binning, evaluation and rotation, the
   aberration with the Aberrator's construction, prefilter, gather and
   rotation, the modulation; the plain-torch stages against their bytes
   bounds over 3.35 TB/s and as shares of the step), the busy share and top
   ops of one profiled step (no host <-> device copy above 1 MB), its
   launches (K10 and K12 and the Legendre entries of its dtype must
   launch), the memory peak (under 70 GiB); the float32 lensed map against
   the float64 one (5e-3), the float64 one at 512 seeded pixels against a
   direct sum at their displaced positions (offset_by_grad on the CPU in
   float64; 1e-8), and zero phi_alm giving the unlensed map (1e-9, ten
   times the NUFFT's epsilon). The
   kernels JSON line gives each kernel's launches in these paths
   ("lensing_launches").
12. config5: BASELINE config 5 (point sources, then wavelets,
   scripts/benchmark_baseline.py:172-236) through pixell_tpu_torch.pointsrcs,
   .uharm, .wavelets and .multimap: the wavelet scales' SHTs on K1-K4 (and
   in float32 their near-pole passes), the painting in plain torch. Guard
   first: the whole chain in float64 at lmax 64 with 200 sources on the
   70 x 140 F1 grid, the card against the same calls on CPU tensors (the
   source map, every scale and the reconstruction within 1e-12 of the
   largest value). Then config 5 at full size, nothing cut: the 10080 x
   20160 F1 map (the smallest with >= lmax + 2 rings and a 2357-smooth
   column count), 10 000 sources from default_rng(0) (dec uniform in +-1.2
   rad, RA in +-pi, amplitudes 0.5-2), a 2' Gaussian on 1000 radii out to
   30', sim_objects -> WaveletTransform(UHT(mode="curved", lmax=10000),
   ButterTrim(step=2)).map2wave -> wave2map (15 scales), in float32: the
   step's ms (CUDA events, median of 2: the driven step and one more; min,
   max) and its stages (srcsim, map2wave, wave2map), its launches (driven
   with the counts at 0; K1-K4
   and the near-pole passes must launch), the memory peak (under 70 GiB),
   the busy share and top ops of one profiled step (no host <-> device copy
   above 1 MB), sim_objects against its bytes bound, K2 / K4's partial
   planes (zero-fill and sum, replayed at the step's shapes) as a share of
   the step; one float64 step (the driven step timed: launches, peak, ms);
   in each dtype
   K3 and K4 at lmax 10000 against an independent reference: a sparse alm
   (58 (l, m) pairs up to l = m = 10000) synthesised by alm2map onto the
   map's rings and held on 252 of them against a numpy direct sum of the
   textbook Legendre recurrence, then analysed back by map2alm and held
   against the sparse alm over the whole triangle (1e-9 in float64, 5e-3
   in float32); the SHT table caches' resident bytes against their budget
   (ops/tablecache.py); the float64 identity wave2map(map2wave(m)) =
   harm2map(sum_i k_i^2 map2harm(m)) at lmax 10000 (1e-9) and the float32
   reconstruction against the float64 one (5e-3). The kernels JSON line
   gives each kernel's launches in these paths ("config5_launches").

13. analysis: the point-source analysis of the DR6-sized band through
   pixell_tpu_torch.distances, .enmap's masks and .analysis, on K13
   (jump_flood_kernel, a launch a flood pass and one to finish) and K14
   (nearest_point_kernel, the brute force over <= 1024 points) of
   csrc/distances.cu. Guards first: K13 and K14 against their plain
   versions on the card (ops/distances_core.py) bit for bit, distances
   and seeds or domains, on a 1024 x 2048 cut of the band (pixel seeds,
   int32 and int64, 1000 point seeds, 1000 points), at nside 256 (brute,
   grid), and on a near-tie set on both (points mirrored about pixel
   centres, triples 1e-15 rad apart); K13 against K14's exact distance on the cut (never
   shorter by more than 1e-12, within it on >= 99.9 % of pixels); the
   whole chain in float64 at 64 x 128 on the card against CPU tensors
   (1e-12 of the largest value). Then the band at full size, T float32:
   10 000 sources (S/N log-uniform 3-300 from the filter's kappa, a 1.4'
   Gaussian beam, at least 16 pixels apart) painted by sim_objects with
   white noise of a smooth ivar; distance_from of the 1000 brightest > 5'
   (K14); apod_mask of the footprint over 1 degree (K13);
   FinderMultiSafe over NmatConstcorr (iC = 1, flat UHT) on the apodized
   map (cuFFT, the host labelling, the circles on K13); inpaint where the
   bright-source mask is False (K13). The first step driven with the
   launch counts at 0 and profiled (busy share, device time by kernel, no
   host <-> device copy above 1 MB outside the finder's named host
   stages), peak memory under 70 GiB, every injected source of expected
   S/N >= 10 found within 2 pixels and every found one of S/N >= 10
   within 2 of an injected one; then 2 steps timed with CUDA events by
   stage and the host stages by wall time (analysis.HOST_MS; 3 before the
   utils phase came, whose time the third step's ~6 s pays for). Once, not
   timed: sim_srcs_dist_transform of all 10 000 sources (K13) against
   sim_objects, and distance_from_points_healpix at nside 2048 for the
   1000 bright sources, brute (K14) and grid (K13). The K13 / K14 records
   (kernel, plain and bound on 256 full-width rows of the band, beside the
   band's own time a launch) with the step's launches; K13 launch by launch
   on the rows and on the band (the first 8 passes against the last 8).

14. mesh: the multi-device maps and transforms (pixell_tpu_torch.parallel,
   .tilemap and mesh= of curvedsky, uharm, wavelets, lensing) on the one
   card, and K1-K4 on an m block (their mfirst argument). The kernel checks
   first (mesh_kernel_checks): K1-K4 (K7 in wigner mode) in float32 and
   float64 and the float64 near-pole passes, in the modes of the mesh
   paths, on the m block 101 .. 129 at lmax 300 (off the m tile), against
   their plain twins on the same block and against the whole launch's
   columns (equal). Then R = 4 ranks' own work emulated in turn at full
   width, the combination (concatenation, the all-to-all by slicing) on
   the card: IQU alm2map -> map2alm at lmax 2000 on the 2160 x 4320 F1
   map, ring-sharded synthesis (K3 on a rank's rows) and the 2d phase
   path's m blocks (K4 with the block's first m), float64: the map within
   1e-12 of K3 on the whole ring set and 1e-11 of one device (whose
   symmetric ring set takes K1), the alm 1e-11 of one device; float32 by
   the float32 rule; the
   2 x 2 mesh's roundtrip_step(shard="m") at lmax 2000 (K4 / K3 on the
   column ranks' m blocks) and 750 (K2 / K1), float64 1e-11, float32 by the
   rule; each rank's ms and bytes beside one device's, and the m-block
   launches (sht_cuda.LAUNCHES_MBLOCK). Then the public entry points on a
   one-rank NCCL mesh against no mesh: curvedsky.alm2map / map2alm of IQU
   and deriv at lmax 2000 (1e-12 / 1e-11), WaveletTransform(UHT(lmax
   2000), mesh=) (1e-10), lens_map_curved(mesh=) at config 4 (1e-10), and
   tilemap from_enmap -> distribute -> redistribute -> to_enmap of the
   DR6-sized band IQU f32 in 500 x 500 tiles (exact). The m-block records
   of K1-K4 (spin2, float32 and float64, at the mesh paths' blocks and
   ring sets) join the kernels line: block time beside the whole launch's,
   bound, chunked torch.bmm, the plain twin's time at the check's shape,
   the mesh path's launches.

15. io: maps on disk (pixell_tpu_torch.fits_io, enmap's IO, tilemap,
   checkpoint, pointsrcs' FITS catalogues), every file in a temporary
   directory chosen for its free bytes (printed) and removed at the end. The
   DR6-sized band (10320 x 43200 at 0.5', dec -63 .. +23, T float32,
   1.78 GB) made on the card, written to FITS and read back whole; read
   delayed and sliced to a 20 x 20 degree box through the native box reader,
   and read with box=; each read equal bit for bit to the map in memory, the
   box reads to its submap; GB/s of the write (the copy to the host, the
   conversion to big endian and the file), of the reads, of the native
   reader into pinned memory alone and of the copy from there to the card
   (CUDA events), and the box read's time as a share of the whole read's.
   Then the SHT in between: IQU float32 on the 2160 x 4320 Fejer-1 map at
   lmax 2000, alm2map of a seeded alm -> write_map -> read_map (equal bit
   for bit) -> map2alm(spin=[0, 2]) (K4 on the 4032 upsampled rings in two
   chunks, K4' in float64) -> alm2map (K1 on the 2160 symmetric rings, K3'
   in float64) -> write_map -> read_map (equal bit for bit), the alm within
   2e-3 of the seeded one, each SHT stage's ms in CUDA events (the path's
   call, then a second call), the launches counted with every count set to
   0 just before and read just after (K1 and K4 must launch). Then the same
   map and its alm through the other writers: .npy, tilemap in 500 x 500
   tiles, checkpoint.save_pytree / load_pytree of the alm and the map (each
   equal bit for bit, with its GB/s), and a FITS catalogue of 10 000
   sources written and read back (its positions as the degrees the file
   holds give them) and painted with pointsrcs.sim_objects onto that
   geometry, equal bit for bit to painting the catalogue it should give
   (and its distance to the catalogue in memory printed).
   device.get_device().memuse() before and after, and the card's name and
   power limit beside the numbers.

16. plot: plotting and the install benchmark (pixell_tpu_torch.scripts,
   .enplot, .colorize, .utils, .bench). scripts.benchmark_main on the card
   (40 float32 roundtrips of spin 0 at lmax 750 on the 900 x 1800 Fejer-1
   map after one of warm-up) with its launches counted (K1, K2 and the
   near-pole passes must launch), its ms a roundtrip beside PERF.md's
   spin-0 lmax-750 f32 row. The DR6-sized band (10320 x 43200, T float32, from a seed):
   enplot.get_color_range and enplot.map_to_color (no PIL) timed with CUDA
   events (median of 3), the colouring against its bytes bound (4 B read
   and 4 B written a pixel), one profiled colouring (its ops; no copy to
   the host above 1 MB), the memory peak (under 70 GiB), and a 1024 x
   2048 cut's range and colours equal bit for bit to the same calls on CPU
   tensors; bench.Bench().mark around map_to_color no shorter than its CUDA
   events. utils.FourierInterpolator on a 2160 x 4320 float64 map at 10^6
   random positions: K12 and K10 must launch, its values at the first 10^5
   within 1e-10 of the same call on CPU tensors at those positions, its
   time. The kernels JSON line gives each
   kernel's launches in these paths ("plot_launches").

17. utils: every helper of pixell_tpu_torch.utils that takes a tensor, on
   the card: the IQU float64 map of 3 x 2160 x 4320 (lmax 2000's size,
   numpy's draws from one seed; a copy with 0.1 % each of NaN, +inf and
   -inf; weights; a mask) through tofinite, remove_nan, without_nan,
   rescale, minmax, medmean2, maskmed, weighted_quantile / _median, the
   reshaping helpers (partial_flatten / _expand, flatview, moveaxes,
   addaxes, delaxes, atleast_3d / _Nd, to_Nd, preflat, postflat, blockify),
   block_mean_filter, slice_downgrade, resize_array, unmask, pixwin_1d,
   triangle_wave, gnfw, vec_angdist (IQU as 3-vectors), ang2chord /
   chord2ang, matvec, deslope, sum_by_id, argmax / argmin, find_first /
   _last; cov2corr, corr2cov, eigsort (E and V E V^T) and nodiag on the
   3 x 3 covariances of a 540 x 540 cut; bincount of 10^7 indices (and
   weighted, in two rows), bin_multi; point_in_polygon of 10^6 points
   against a 16-vertex star and poly_edge_dist of 10^6 sky points from a
   16-gon. Each result must be CUDA tensors, held against the same call
   on CPU tensors: bit for bit for integer, boolean and exact elementwise
   results (IEEE operations only), within 1e-12 of the largest value for
   reductions, sorts, linear algebra and transcendental functions. The
   CUDA-event ms (median of 3) of tofinite, maskmed, weighted_median,
   bincount and point_in_polygon beside the card's name and power limit.
   No kernel of the port's own: torch runs these on the card. The card
   runs each call on the whole inputs (its result must be CUDA tensors)
   and on an eighth of them (the first eighth of the map's rows, of the
   covariances, of the indices and of the points), which is held against
   the CPU tensors' call. The phase runs first, before the kernel phases.

It prints the card's name and power limit, one JSON line with each
kernel's launches, error, time, bound and yardstick, and as the last line
{"ok": true, "device": {...}}. Any failure raises, and the exit code is then
nonzero; without a CUDA device it exits with code 2.
"""
import argparse
import contextlib
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
			j = re.search(r"jump_flood_kernelI([ix])Lb([01])E", m.group(1))
			r = re.search(r"nearest_point_kernelILb([01])E", m.group(1))
			geo = lambda g: "sep" if g == "1" else "general"
			d = "nearest_point<%s>" % geo(r.group(1)) if r else \
				"jump_flood<%s,%s>" % ("int32" if j.group(1) == "i" else "int64", geo(j.group(2))) if j else None
			entry = d or ("fma_peak<%s>" % f.group(1) if f else
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


def kernel_ops(name, mode, lmax, mmax, nt, C, dead=None, split=False, m0=0):
	"""The operations of kernel name (either form of synthesis or
	analysis) in mode, on the m rows m0 .. mmax: their sum, or with split
	(recurrence and mode functions, accumulation)."""
	from pixell_tpu_torch.ops import sht_cuda
	from pixell_tpu_torch.ops.sht_core import NFUN
	rings = np.full(mmax + 1 - m0, nt) if dead is None else \
		sht_cuda.live_mask(dead, mmax + 1 - m0, nt).sum(1).cpu().numpy()
	first = np.maximum(np.arange(m0, mmax + 1), mode_spin(mode) or 0)   # each row's seed degree
	triples = int((rings*np.maximum(lmax + 1 - first, 0)).sum())
	ops = (triples*(STEP_OPS + MODE_OPS[mode]), triples*2*C*NFUN[mode])
	return ops if split else sum(ops)


def kernel_bytes(name, mode, lmax, mmax, nt, C, esize, m0=0):
	"""Each input read once and each output written once: the alm or ring
	data, the coefficient and degree tables, the ring rows and seeds, of
	the m rows m0 .. mmax."""
	from pixell_tpu_torch.ops.sht_core import NFUN
	nl, nm, nf = lmax + 1, mmax + 1 - m0, NFUN[mode]
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
			ref, plain_ms = timed_once(lambda: plain(x, g64, lmax, mode))
			plain_ms = {torch.float64: plain_ms}   # the float64 plain call is args' own in float64
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
					p, plain_ms[dt] = timed_once(lambda: plain(*args))
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
				"plain_ms": plain_ms[main_dt],
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
	lmax 2000 only the timed modes, at ncoef's C (the other modes are held
	at lmax 750); scalar and spin2 (wigner for the wigner rows) are timed,
	at ncoef's C."""
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
		("sym_synthesis", 2000, m2000[:sht_cuda.detect_sym(m2000)], one(timed), timed),
		("full_analysis", 2000, up(2000)[:sht_cuda.TCHUNK], one(timed), timed),
		("full_synthesis", 2000, up(2000), one(timed), timed),
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
	syn_cols = lambda name, a: a[..., :2] if name.endswith("synthesis") else a[:, :2]
	out_cols = lambda name, a: a[:, :2] if name.endswith("synthesis") else a[..., :2]
	for i, (name, lmax, theta, held, timed) in enumerate(f64_row_cases()):
		kern, plain, nt = getattr(sht_cuda, name), sht_cuda.PLAIN[name], len(theta)
		last = {}   # per mode, (input, plain result, ms) at C = 4: a C = 2 hold takes its first two columns
		for mode, C in sorted(held, key=lambda mc: -mc[1]):
			s = mode_spin(mode)
			g = sht_cuda.geom(theta, lmax, f64, dev, s)
			if C == 2 and mode in last:
				x4, ref4, plain_ms = last[mode]
				x, ref, plain_C = syn_cols(name, x4).contiguous(), out_cols(name, ref4), 4
			else:
				x = torch.from_numpy(kernel_input(name, mode, lmax, lmax, nt, 80 + i, C)).to(dev)
				ref, plain_ms = timed_once(lambda: plain(x, g, lmax, mode))
				plain_C = C
				if C == 4: last[mode] = (x, ref, plain_ms)
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
				lib_ms, lib_err = chunked_library_ms(name, mode, x, theta, lmax, ref=ref)
			if not lib_err <= 1e-10:
				raise RuntimeError("%s %s: the float64 yardstick computes another function" % (name, mode))
			entry = sht_cuda.BULK_F64[name]
			rec = {"name": "%s[%s, lmax %d, nt %d]" % (entry, mode, lmax, nt), "route": "cuda",
				"source": LEGENDRE_SOURCE, "replaces": REPLACES[name], "mode": mode,
				"max_abs_err": float((k - ref).abs().max()), "rel_err": err, "ms": ms, "ms_from": how,
				"plain_C": plain_C,
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
		del last
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


# the modes of the lmax-2000 paths: the roundtrips (spin 0, IQU, spin [0, 3]) and the mesh phase's deriv
LMAX2000_MODES = ("scalar", "deriv", "spin2", "wigner")


def polar_shapes(pname, mode):
	"""pname (polar_analysis or polar_synthesis) against its float64 plain
	version at two more shapes. (1) Where its ring-tile loop runs and no
	tiling divides the m rows: the 202 near-pole rings of a 3929-ring
	Clenshaw-Curtis map at lmax 750, the poles among them (where the spin
	modes take their limits), 130 m rows, and 6 columns, which take two
	launches (4 + 2) into one output. (2) The lmax-2000 main path's: the
	near-pole rings of the 2160-ring Fejer-1 map (synthesis) or of its
	upsampled rings (analysis), the near-pole m rows, the mode's columns,
	in the modes of the lmax-2000 paths (LMAX2000_MODES)."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	s = mode_spin(mode)
	cc = sht.ring_theta("CC", 3929)
	syn = pname == "polar_synthesis"
	f1 = sht.ring_theta("F1", 2160 if syn else fft.fft_len(2*2000 + 3, direction="above"))
	pm = (sht_cuda.POLAR_MMAX if s is None else max(sht_cuda.POLAR_MMAX, s + 1)) - 1
	shapes = [(cc, 750, 129, 6)]
	if mode in LMAX2000_MODES: shapes.append((f1, 2000, pm, ncoef(mode)))
	for i, (th, lmax, mmax, C) in enumerate(shapes):
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


def chunked_library_ms(name, mode, x, theta, lmax, mchunk=64, ref=None):
	"""(ms, rel err) of the library yardstick of kernel name at a shape whose
	mode-function table [nm, nfun*nt, nl] does not fit in memory whole:
	torch.bmm over m in chunks of mchunk rows, the times of the chunks
	summed. Each chunk multiplies a table of its own shape; the table is
	that of the first chunk (m < mchunk), built once, whose product is held
	against the float64 plain version on those rows: ref's, the caller's
	float64 plain result on all of x, where it has one (its rows m < mchunk
	are the same numbers), else a plain call on them. The values do not
	change a dense product's time."""
	from pixell_tpu_torch.ops import sht_cuda
	syn = name.endswith("synthesis")
	head = lambda a: (a[:, :mchunk] if syn else a[..., :mchunk, :]).contiguous()
	T, Bh, layout = library_call(name, mode, head(x), theta, mchunk - 1, lmax)
	if ref is not None:
		ref = (ref[..., :mchunk, :] if syn else ref[:, :mchunk]).double()
	else:
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
	of the upsampled bulk rings (the second in scalar). Each is held against
	the float64 plain
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
			("full_analysis", "chunk 1", "wigner lmax 2000"))))
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
			lib_ms, lib_err = chunked_library_ms(name, mode, x, theta, lmax, ref=ref)
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
	m = curvedsky.alm2map(alm, enmap.zeros(mshape, wcs, dtype, device=device), spin=list(spin))
	alm2 = curvedsky.map2alm(m, lmax=lmax, spin=list(spin))
	m2 = curvedsky.alm2map(alm2, enmap.zeros(mshape, wcs, dtype, device=device), spin=list(spin))
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
	d = curvedsky.alm2map(alm, enmap.zeros((2,) + gshape, wcs, dtype, device=device), deriv=True)
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
		p2, plain_ms = timed_once(lambda: blk_plain(x32, kstate, tab, g32, lmax, mode))
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
F64_ANA_B = "constexpr int f64_analysis_blocks(int C, bool SYM) { return %s; }"
F64_SYN = "constexpr int f64_synthesis_rings(int C) { return %s; }"
F64_SYN_B = "constexpr int f64_synthesis_blocks(int C) { return %s; }"
F64_SYN_RB = F64_SYN + "\n__host__ __device__ " + F64_SYN_B   # the two lines together
BULK_VARIANTS = {
	"R = 2": (F32_ANA % "MODE == SCALAR && !SYM ? 4 : 2", F32_ANA % "2"),
	"R = 4": (F32_ANA % "MODE == SCALAR && !SYM ? 4 : 2", F32_ANA % "4"),
	"gl0 == l8": ("else if (gl0 < lseed)", "else if (gl0 == l8)"),
	"synthesis R = 1": (F32_SYN % "MODE == SCALAR ? 2 : 1", F32_SYN % "1"),
	"synthesis R = 2": (F32_SYN % "MODE == SCALAR ? 2 : 1", F32_SYN % "2"),
	"north/mirror sums": ("constexpr bool SYNTH_EVEN_ODD = true;", "constexpr bool SYNTH_EVEN_ODD = false;"),
	"f64 R = 1": (F64_ANA % "MODE == DERIV && C == 4 ? 1 : 2", F64_ANA % "1"),
	"f64 analysis 3 blocks": (F64_ANA_B % "MODE == DERIV && C == 2 ? (SYM ? 2 : 3) : 1", F64_ANA_B % "3"),
	"f64 analysis uncapped": (F64_ANA_B % "MODE == DERIV && C == 2 ? (SYM ? 2 : 3) : 1", F64_ANA_B % "1"),
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
	blockleg.cu and / or nufft.cu in the directory csrc (--parent), with the
	entry points that parent_kernels, blocked_kernels and parent_nufft call
	declared: the float32 bulk entries and the float64 ones the parent has,
	its blk_synthesis entries, its unbinned K10 / K11.
	lib.has_legendre, lib.has_blk and lib.has_nufft say which it held.
	lib.f64_entry maps each float64 bulk entry of this tree
	(sym_bulk_synthesis_f64, ...) to the parent's: the same, or in a parent
	that predates them the entry of synthesis_kernel / analysis_kernel
	named after the wrapper (sym_synthesis, ...). Its Legendre entries are
	declared with this tree's arguments, the m block's first m last: a
	parent's legendre.cu must take it (int mfirst)."""
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
			fn.argtypes = [I] + [P]*9 + [I]*(4 if "synthesis" in name else 5) + [P]*3 + [I]
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


DIST_INSTANTIATIONS = tuple("jump_flood<%s,%s>" % (t, g) for t in ("int32", "int64") for g in ("sep", "general")) \
	+ tuple("nearest_point<%s>" % g for g in ("sep", "general"))


def dist_build_check(rows):
	"""K13 and K14 among print_build_summary's rows: jump_flood_kernel for
	int32 and int64 seeds and nearest_point_kernel, each for separable and
	general geometries (DIST_INSTANTIATIONS), none spilling. Raises
	otherwise."""
	got = [r for r in rows if r[1].startswith(("jump_flood<", "nearest_point"))]
	print("ptxas: %d distance instantiations (of %d): %s" % (len(got), len(DIST_INSTANTIATIONS), ", ".join(
		"%s %d registers, %d bytes spilled" % (e, n, b) for _, e, n, b in got)))
	if sorted(r[1] for r in got) != sorted(DIST_INSTANTIATIONS) or any(r[3] for r in got):
		raise RuntimeError("K13 / K14: %s built, %d spill" % ([r[1] for r in got], sum(bool(r[3]) for r in got)))


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


# ---------------------------------------------------------------------------
# 8. flat: the flat-sky path (BASELINE config 1 and an ACT DR6-sized band)
# ---------------------------------------------------------------------------
FLAT_BINS = 64                                  # scripts/benchmark_baseline.py:64
FLAT_RT_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}   # ifft(fft) / harm2map(map2harm)
FLAT_CPU_TOL = 1e-12                            # card against CPU tensors, float64
FLAT_BIN_TOL = 1e-6                             # lbin against numpy's bincount
FLAT_MEM_GIB = 70
FLAT_COPY_BYTES = 1 << 20                       # no host <-> device copy above this in a step


def flat_time(fn, nstep, nrep=7):
	"""(median, min, max) ms of one call of fn: CUDA events around nstep
	calls, nrep times, after one warm-up call."""
	fn()
	torch.cuda.synchronize()
	times = []
	for _ in range(nrep):
		t0 = torch.cuda.Event(enable_timing=True)
		t1 = torch.cuda.Event(enable_timing=True)
		t0.record()
		for _ in range(nstep): fn()
		t1.record()
		torch.cuda.synchronize()
		times.append(t0.elapsed_time(t1)/nstep)
	return float(np.median(times)), min(times), max(times)


def flat_profile(fn, rows, label, limit=FLAT_COPY_BYTES):
	"""(wall ms, device busy ms) of fn under the profiler, whose device time
	by op it prints (rows rows); fails on a host <-> device copy above
	limit bytes, read from the trace's memcpy records (their bytes, or
	where a record has none, a duration above 50 us)."""
	from torch.profiler import profile, ProfilerActivity
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		h0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		wall = (time.perf_counter() - h0)*1e3
	ka = prof.key_averages()
	key = _device_key(ka)
	busy = sum(getattr(e, key) for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
		and not getattr(e, "is_user_annotation", False))/1e3
	print(ka.table(sort_by=key, row_limit=rows, max_name_column_width=56))
	path = os.path.join(ROOT, "build", "flat_trace.json")
	os.makedirs(os.path.dirname(path), exist_ok=True)
	prof.export_chrome_trace(path)
	with open(path) as f: events = json.load(f)["traceEvents"]
	os.remove(path)
	copies = [(e.get("name", ""), (e.get("args") or {}).get("bytes"), e.get("dur", 0)) for e in events
		if e.get("cat") == "gpu_memcpy" and ("HtoD" in e.get("name", "") or "DtoH" in e.get("name", ""))]
	big = [c for c in copies if (c[1] is not None and c[1] > limit) or (c[1] is None and c[2] > 50)]
	print("flat %s: one profiled call: wall %.3f ms, device busy %.3f ms (%.1f %%); %d host <-> device "
		"copies, largest %s bytes" % (label, wall, busy, 100*busy/wall, len(copies),
		max((c[1] or 0 for c in copies), default=0)))
	if big: raise RuntimeError("flat %s: host <-> device copies above %d bytes: %s" % (label, limit, big))
	return wall, busy


def flat_cfg1_geometry():
	"""BASELINE config 1's geometry (scripts/benchmark_baseline.py:60-61)."""
	from pixell_tpu_torch import enmap, utils
	return enmap.geometry(pos=[[-5*utils.degree, 5*utils.degree], [5*utils.degree, -5*utils.degree]],
		shape=(256, 512), proj="car")


def flat_cfg1_bins(shape, wcs, device):
	"""Config 1's bin of each Fourier pixel: FLAT_BINS equal bins of |l|
	from 0 to its largest (scripts/benchmark_baseline.py:62-64), and each
	bin's count (at least 1)."""
	from pixell_tpu_torch import enmap
	l = enmap.modlmap(shape, wcs, device=device).data.reshape(-1)
	edges = torch.linspace(0, float(l.max()), FLAT_BINS + 1, dtype=torch.float64, device=device)
	ibin = (torch.searchsorted(edges, l) - 1).clamp_(0, FLAT_BINS - 1)
	return ibin, torch.bincount(ibin, minlength=FLAT_BINS).clamp_(min=1)


def flat_cfg1_step(m, ibin, cnt):
	"""Config 1's step (scripts/benchmark_baseline.py:65-72): (the map back
	from ifft(fft), its binned 2d spectrum), the bins summed in float64."""
	from pixell_tpu_torch import enmap
	fm = enmap.fft(m)
	p2d = enmap.calc_ps2d(fm).data.reshape(-1).to(torch.float64)
	cl = torch.zeros(FLAT_BINS, dtype=torch.float64, device=p2d.device).index_add_(0, ibin, p2d)
	return enmap.ifft(fm).real.data, (cl/cnt).to(m.dtype)


def flat_cfg1(dtype):
	"""Config 1 in dtype: guards, then the timing and one profile."""
	from pixell_tpu_torch import enmap
	shape, wcs = flat_cfg1_geometry()
	ibin, cnt = flat_cfg1_bins(shape, wcs, DEV)
	x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)).to(DEV, dtype)
	m = enmap.ndmap(x, wcs)
	back, cl = flat_cfg1_step(m, ibin, cnt)
	err = relerr(back, x)
	tag = str(dtype)[6:]
	line = "flat config 1 %s: ifft(fft) rel err %.3e (bound %.0e)" % (tag, err, FLAT_RT_TOL[dtype])
	if dtype == torch.float64:
		cib, ccnt = flat_cfg1_bins(shape, wcs, "cpu")
		_, ccl = flat_cfg1_step(enmap.ndmap(x.cpu(), wcs), cib, ccnt)
		cerr = relerr(cl.cpu(), ccl)
		line += "; spectrum against CPU tensors %.3e (bound %.0e)" % (cerr, FLAT_CPU_TOL)
		if not cerr <= FLAT_CPU_TOL: raise RuntimeError(line)
	print(line)
	if not err <= FLAT_RT_TOL[dtype]: raise RuntimeError(line)
	med, lo, hi = flat_time(lambda: flat_cfg1_step(m, ibin, cnt), 100)
	def rep():
		for _ in range(100): flat_cfg1_step(m, ibin, cnt)
	wall, busy = flat_profile(rep, 10, "config 1 %s, 100 steps" % tag)
	print("flat config 1 %s: %.4f ms a step (median of 7 repeats of 100 steps; min %.4f, max %.4f); device "
		"busy %.1f %% of one profiled repeat" % (tag, med, lo, hi, 100*busy/wall))


def flat_bins_host(shape, wcs, ps):
	"""lbin of ps [..., ny, nx] (a host float64 copy) by numpy: the bin of
	each Fourier pixel from the host l axes, np.bincount sums and counts."""
	from pixell_tpu_torch import enmap
	ly, lx = enmap.laxes(shape, wcs)
	bsize = min(abs(lx[1]), abs(ly[1]))
	pix = (np.sqrt(ly[:, None]**2 + lx[None, :]**2)/bsize).astype(int).reshape(-1)
	nhit = np.bincount(pix)
	flat = ps.reshape((-1, pix.size))
	return np.array([np.bincount(pix, weights=f, minlength=nhit.size) for f in flat])/np.maximum(nhit, 1)


def flat_dr6(dtype):
	"""The DR6-sized band in dtype: IQU through map2harm / lbin / harm2map
	in float32, T through fft / lbin / ifft in float64."""
	from pixell_tpu_torch import enmap, utils
	shape, wcs = enmap.band_geometry(np.array([-63, 23])*utils.degree, res=0.5*utils.arcmin)
	iqu = dtype == torch.float32
	mshape = ((3,) if iqu else ()) + tuple(shape)
	tag = "IQU float32" if iqu else "T float64"
	gen = torch.Generator(device=DEV)
	gen.manual_seed(17)
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	m = enmap.ndmap(torch.randn(mshape, generator=gen, device=DEV, dtype=dtype), wcs)
	if iqu:
		fwd = lambda x: enmap.map2harm(x, normalize="phys", spin=[0, 2])
		inv = lambda f: enmap.harm2map(f, normalize="phys", spin=[0, 2])
	else:
		fwd = lambda x: enmap.fft(x)
		inv = lambda f: enmap.ifft(f).real
	def step():
		f = fwd(m)
		vals = enmap.lbin(enmap.calc_ps2d(f))[0]
		return inv(f), vals
	back, vals = step()
	err = relerr(back.data, m.data)
	del back
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	print("flat DR6 %s: %s map, harm2map(map2harm) rel err %.3e (bound %.0e); %d bins; peak device memory "
		"%.2f GiB (bound %d)" % (tag, mshape, err, FLAT_RT_TOL[dtype], vals.shape[-1], peak, FLAT_MEM_GIB))
	if not err <= FLAT_RT_TOL[dtype]: raise RuntimeError("flat DR6 %s: roundtrip error %g" % (tag, err))
	if not peak < FLAT_MEM_GIB: raise RuntimeError("flat DR6 %s: peak memory %.2f GiB" % (tag, peak))
	# the binned spectrum against numpy's bincount of the same |F|^2, of the first component (the
	# binning is the same function on each; the host bincount of all three took ~20 s)
	f = fwd(m)
	ps = enmap.calc_ps2d(f)
	if ps.ndim > 2: ps = ps[:1]
	got = enmap.lbin(ps)[0].cpu().numpy().reshape(-1, vals.shape[-1])
	want = flat_bins_host(shape, wcs, ps.data.cpu().numpy().astype(np.float64))
	berr = float(np.max(np.abs(got - want))/np.max(np.abs(want)))
	print("flat DR6 %s: lbin against numpy's bincount of the same |F|^2: rel err %.3e (bound %.0e)" % (
		tag, berr, FLAT_BIN_TOL))
	if not berr <= FLAT_BIN_TOL: raise RuntimeError("flat DR6 %s: binned spectrum off by %g" % (tag, berr))
	# stages, and the two passes a later kernel could take: the rotation (in
	# place on a copy of f) and the binning, against their bytes bounds
	n = int(np.prod(shape))
	esize = torch.finfo(dtype).bits//8
	stages = [("forward" if not iqu else "map2harm", lambda: fwd(m)), ("calc_ps2d", lambda: enmap.calc_ps2d(f)),
		("lbin", lambda: enmap.lbin(ps)), ("inverse" if not iqu else "harm2map", lambda: inv(f))]
	for name, fn in stages:
		med, lo, hi = flat_time(fn, 1, 3)
		print("flat DR6 %s: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (tag, name, med, lo, hi))
	nb = ps.data.numel()*esize   # lbin reads |F|^2 once
	med, lo, hi = flat_time(lambda: enmap.lbin(ps), 1, 3)
	print("flat DR6 %s: binning %.3f ms, bytes bound %.3f ms (%.1f %%; %.2f GB read)" % (tag, med,
		1e3*nb/PEAK_BYTES, 100*1e3*nb/PEAK_BYTES/med, nb/1e9))
	if iqu:
		from pixell_tpu_torch.enmap import _rotate_spins
		g = f.data.clone()
		nr = 4*n*2*esize   # Q and U read and written, complex
		med, lo, hi = flat_time(lambda: _rotate_spins(g, wcs, [0, 2], False, False), 1, 3)
		print("flat DR6 %s: QU -> EB rotation %.3f ms, bytes bound %.3f ms (%.1f %%; %.2f GB)" % (tag, med,
			1e3*nr/PEAK_BYTES, 100*1e3*nr/PEAK_BYTES/med, nr/1e9))
		del g
	del f, ps
	torch.cuda.empty_cache()
	torch.cuda.reset_peak_memory_stats()
	med, lo, hi = flat_time(step, 1)
	wall, busy = flat_profile(step, 12, "DR6 %s step" % tag)
	print("flat DR6 %s: %.3f ms a step (median of 7; min %.3f, max %.3f); device busy %.1f %% of one profiled "
		"step; peak %.2f GiB" % (tag, med, lo, hi, 100*busy/wall, torch.cuda.max_memory_allocated()/2**30))
	del m
	torch.cuda.empty_cache()


def flat_rand_map():
	"""rand_map of IQU at 1024 x 2048 in float64, on the card and on CPU
	tensors from one seed."""
	from pixell_tpu_torch import enmap, utils
	shape, wcs = enmap.geometry(pos=np.array([[-10, 20], [10, -20]])*utils.degree, shape=(1024, 2048),
		proj="car")
	l = np.arange(30000.)
	cov = np.zeros((3, 3, l.size))
	cov[0, 0] = 1/(l + 10)**2
	cov[1, 1] = cov[2, 2] = 0.1/(l + 10)**2
	cov[0, 1] = cov[1, 0] = 0.2/(l + 10)**2
	got = enmap.rand_map((3,) + shape, wcs, cov, seed=5, device=DEV)
	want = enmap.rand_map((3,) + shape, wcs, cov, seed=5, device="cpu")
	err = relerr(got.data.cpu(), want.data)
	print("flat rand_map IQU (3, 1024, 2048) float64: card against CPU tensors rel err %.3e (bound %.0e)" % (
		err, FLAT_CPU_TOL))
	if not err <= FLAT_CPU_TOL: raise RuntimeError("flat rand_map: card and CPU differ by %g" % err)


def flat_phase():
	"""Config 1 in float32 and float64, the DR6 band, rand_map."""
	for dt in (torch.float32, torch.float64): flat_cfg1(dt)
	for dt in (torch.float32, torch.float64): flat_dr6(dt)
	flat_rand_map()


# ---------------------------------------------------------------------------
# 9. interp: pixel-space reprojection (project / at, map_coordinates and its
# transpose, resolution changes, cut-outs) on the DR6-sized band
# ---------------------------------------------------------------------------
INTERP_F32_TOL = 2e-5          # float32 against float64 or the CPU (tests/test_torch_enmap_pixel.py)
INTERP_CPU_TOL = 1e-12         # card against CPU tensors, float64
INTERP_NODE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}   # order-3 spline at the pixel centres
INTERP_ADJ_TOL = 1e-12         # <A x, y> = <x, A^T y>, float64, relative
INTERP_NPT = 4_000_000         # catalogue positions for at
INTERP_BSIZE = 1000            # project's block of output rows


def interp_band(dtype, seed):
	"""The DR6-sized band (the flat phase's) with white noise from a seeded
	generator on the card: IQU in float32, T in float64."""
	from pixell_tpu_torch import enmap, utils
	shape, wcs = enmap.band_geometry(np.array([-63, 23])*utils.degree, res=0.5*utils.arcmin)
	gen = torch.Generator(device=DEV)
	gen.manual_seed(seed)
	mshape = ((3,) if dtype == torch.float32 else ()) + tuple(shape)
	return enmap.ndmap(torch.randn(mshape, generator=gen, device=DEV, dtype=dtype), wcs)


def interp_target():
	"""The CEA geometry of the band's footprint at 0.5 arcmin (8813 x 43200)."""
	from pixell_tpu_torch import enmap, utils
	return enmap.geometry(pos=np.array([[-63, 180], [23, -180]])*utils.degree, res=0.5*utils.arcmin, proj="cea")


def interp_share(label, ms, nbytes):
	"""A line with ms against the bytes bound nbytes / 3.35 TB/s."""
	b = 1e3*nbytes/PEAK_BYTES
	print("interp %s: %.3f ms, bytes bound %.3f ms (%.2f %% of it; %.2f GB)" % (label, ms, b, 100*b/ms, nbytes/1e9))
	return b


def interp_project(dtype):
	"""enmap.project of the band onto the CEA geometry at order 3, border
	"constant": time (median of 7), stages, busy share, peak, bytes bound;
	the order-3 spline reproducing the map at its own pixel centres."""
	from pixell_tpu_torch import enmap, interpol
	tag = "IQU float32" if dtype == torch.float32 else "T float64"
	torch.cuda.empty_cache()
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	m = interp_band(dtype, 18)
	shape, wcs = interp_target()
	out = enmap.project(m, shape, wcs)
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	if tuple(out.shape) != tuple(m.shape[:-2]) + tuple(shape) or not bool(torch.isfinite(out.data).all()):
		raise RuntimeError("interp project %s: output %s not finite or of the wrong shape" % (tag, out.shape))
	print("interp project %s: %s -> %s (CEA), peak device memory %.2f GiB (bound %d)" % (tag, m.shape, out.shape,
		peak, FLAT_MEM_GIB))
	if not peak < FLAT_MEM_GIB: raise RuntimeError("interp project %s: peak %.2f GiB" % (tag, peak))
	del out
	med, lo, hi = flat_time(lambda: enmap.project(m, shape, wcs), 1)
	print("interp project %s: %.3f ms a call (median of 7; min %.3f, max %.3f)" % (tag, med, lo, hi))
	esize = torch.finfo(dtype).bits//8
	ncomp = m.data.numel()//int(np.prod(m.shape[-2:]))
	npt = int(np.prod(shape))
	nmap, nout = m.data.numel()*esize, ncomp*npt*esize
	interp_share("project %s" % tag, med, nmap + nout)
	# the stages: the positions (the two axes mapped on the host and copied),
	# the prefilter of the whole map, the gather (rows, then columns, by
	# blocks of INTERP_BSIZE output rows)
	data = m.data.reshape((-1,) + m.shape[-2:])
	pos = lambda: enmap._project_axes(m.shape, m.wcs, shape, wcs, True, DEV)
	ty, tx = pos()
	pre = lambda: interpol._coefficients(data, "spline", 3, "constant", True)
	coef, padded = pre()
	def gather():
		for y1 in range(0, shape[-2], INTERP_BSIZE):
			interpol._gather_grid(coef, ty[y1:y1+INTERP_BSIZE], tx, "spline", 3, "constant", padded, 0.0)
	for name, fn, nb in [("positions", pos, 8*sum(shape)), ("prefilter", pre, nmap + coef.numel()*esize),
			("gather", gather, coef.numel()*esize + nout)]:
		smed, slo, shi = flat_time(fn, 1, 3)
		print("interp project %s: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (tag, name, smed, slo, shi))
		interp_share("project %s stage %s" % (tag, name), smed, nb)
	del ty, tx, coef
	torch.cuda.empty_cache()
	wall, busy = flat_profile(lambda: enmap.project(m, shape, wcs), 14, "project %s (separable: the axes' copies "
		"only)" % tag)
	print("interp project %s: device busy %.1f %% of one profiled call" % (tag, 100*busy/wall))
	# the order-3 spline at INTERP_NPT of the map's own pixel centres gives
	# the map back (the coefficients of the whole map, its border included)
	g = torch.Generator(device=DEV)
	g.manual_seed(21)
	iy = torch.randint(0, m.shape[-2], (INTERP_NPT,), generator=g, device=DEV)
	ix = torch.randint(0, m.shape[-1], (INTERP_NPT,), generator=g, device=DEV)
	got = interpol.map_coordinates(data, torch.stack([iy, ix]).to(torch.float64), border="constant")
	err = relerr(got, data[:, iy, ix])
	print("interp %s: order-3 spline at %d pixel centres, rel err %.3e (bound %.0e)" % (tag, INTERP_NPT, err,
		INTERP_NODE_TOL[dtype]))
	if not err <= INTERP_NODE_TOL[dtype]: raise RuntimeError("interp %s: nodes not reproduced (%g)" % (tag, err))
	return med


def interp_at(m):
	"""enmap.at of the IQU float32 band at INTERP_NPT positions drawn
	uniformly in it (order 3 and 1), the transpose and deriv=True at the same
	points: times, stages and bytes bound."""
	from pixell_tpu_torch import enmap, interpol, utils
	rng = np.random.default_rng(19)
	pos = np.array([rng.uniform(-63, 23, INTERP_NPT), rng.uniform(-180, 180, INTERP_NPT)])*utils.degree
	esize = 4
	nmap = m.data.numel()*esize
	nio = INTERP_NPT*(16 + 3*esize)   # positions read, values written
	res = {}
	for order in (3, 1):
		v = enmap.at(m, pos, order=order)
		if tuple(v.shape) != (3, INTERP_NPT) or not bool(torch.isfinite(v).all()):
			raise RuntimeError("interp at order %d: %s not finite or of the wrong shape" % (order, v.shape))
		med, lo, hi = flat_time(lambda: enmap.at(m, pos, order=order), 1)
		print("interp at IQU float32, %d points, order %d: %.3f ms a call (median of 7; min %.3f, max %.3f)" % (
			INTERP_NPT, order, med, lo, hi))
		interp_share("at order %d" % order, med, nmap + nio)
		res[order] = med
	pix = torch.from_numpy(enmap.sky2pix(m.shape, m.wcs, pos)).to(DEV)
	data = m.data
	stages = [("positions (host sky2pix, one copy)", lambda: torch.from_numpy(enmap.sky2pix(m.shape, m.wcs,
		pos)).to(DEV), 16*INTERP_NPT),
		("prefilter", lambda: interpol._coefficients(data, "spline", 3, "constant", True), 2*nmap),
		("gather", lambda: interpol.map_coordinates(data, pix, order=3, border="constant", prefilter=False), nio)]
	for name, fn, nb in stages:
		smed, slo, shi = flat_time(fn, 1, 3)
		print("interp at order 3: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (name, smed, slo, shi))
		interp_share("at order 3 stage %s" % name, smed, nb)
	wall, busy = flat_profile(lambda: enmap.at(m, pos), 12, "at order 3", limit=16*INTERP_NPT)
	print("interp at order 3: device busy %.1f %% of one profiled call" % (100*busy/wall))
	vals = enmap.at(m, pos).data
	for label, fn in [("transpose (trans=True)", lambda: interpol.map_coordinates(data, pix, odata=vals, order=3,
			border="constant", trans=True)),
			("deriv=True", lambda: interpol.map_coordinates(data, pix, order=3, border="constant", deriv=True))]:
		r = fn()
		if not bool(torch.isfinite(r).all()): raise RuntimeError("interp %s: not finite" % label)
		med, lo, hi = flat_time(fn, 1)
		print("interp map_coordinates %s, IQU float32 at %d points, order 3: %.3f ms a call (median of 7; "
			"min %.3f, max %.3f)" % (label, INTERP_NPT, med, lo, hi))
		interp_share("map_coordinates %s" % label, med, nmap + nio + (INTERP_NPT*3*esize if "deriv" in label else 0))
		del r
	return res


def interp_pixel_ops(m):
	"""downgrade / upgrade by 2, resample by 0.5 (fft), apod by 120 pixels,
	and a 20 x 20 degree submap across RA = 180 inserted back, on the IQU
	float32 band."""
	from pixell_tpu_torch import enmap, resample, utils
	nmap = m.data.numel()*4
	for label, fn, nb in [("downgrade 2", lambda: enmap.downgrade(m, 2), nmap*5//4),
			("upgrade 2", lambda: enmap.upgrade(m, 2), nmap*5),
			("resample 0.5 (fft)", lambda: resample.resample(m, 0.5), nmap*5//4),
			("apod 120", lambda: enmap.apod(m, 120), 2*nmap)]:
		r = fn()
		if not bool(torch.isfinite(r.data).all()): raise RuntimeError("interp %s: not finite" % label)
		del r
		med, lo, hi = flat_time(fn, 1, 3)
		print("interp %s IQU float32: %.3f ms (median of 3; min %.3f, max %.3f)" % (label, med, lo, hi))
		interp_share(label, med, nb)
		torch.cuda.empty_cache()
	box = np.array([[-30, 190], [-10, 170]])*utils.degree
	s = m.submap(box)
	back = enmap.zeros(m.shape, m.wcs, m.dtype, device=DEV)
	enmap.insert(back, s)
	again = back.submap(box)
	pb = enmap.subinds(m.shape, m.wcs, box, noflip=True)
	cols = torch.arange(int(pb[0, 1]), int(pb[1, 1]), device=DEV) % m.shape[-1]   # wrapped in RA
	inside = m.data[..., int(pb[0, 0]):int(pb[1, 0]), :][..., cols]
	exact = bool((again.data == s.data).all()) and bool((s.data == inside).all()) and \
		int((back.data != 0).sum()) == int((s.data != 0).sum())
	print("interp submap of a 20 x 20 degree box across RA = 180: %s, pixbox %s; insert(submap) roundtrip exact: %s"
		% (tuple(s.shape), pb.tolist(), exact))
	if not exact: raise RuntimeError("interp: insert(submap) roundtrip not exact")
	med, lo, hi = flat_time(lambda: m.submap(box), 1, 3)
	print("interp submap IQU float32: %.3f ms (median of 3; min %.3f, max %.3f)" % (med, lo, hi))
	med, lo, hi = flat_time(lambda: enmap.insert(back, s), 1, 3)
	print("interp insert IQU float32: %.3f ms (median of 3; min %.3f, max %.3f)" % (med, lo, hi))


def interp_guards():
	"""On a 1024 x 2048 map: the card's project / at / transpose / deriv /
	downgrade / submap against the same functions on CPU tensors (1e-12 in
	float64, INTERP_F32_TOL in float32), and the adjointness of
	map_coordinates in float64."""
	from pixell_tpu_torch import enmap, interpol, utils
	shape, wcs = enmap.geometry(pos=np.array([[-10, 20], [10, -20]])*utils.degree, shape=(1024, 2048), proj="car")
	cshape, cwcs = enmap.geometry(pos=np.array([[-9, 19], [9, -19]])*utils.degree, res=1.3*utils.arcmin, proj="cea")
	rng = np.random.default_rng(20)
	x = rng.standard_normal((3,) + shape)
	pos = np.array([rng.uniform(-10, 10, 100_000), rng.uniform(-20, 20, 100_000)])*utils.degree
	box = np.array([[-3, 5], [4, -2]])*utils.degree
	y = rng.standard_normal((3, 100_000))
	for dt, tol in ((torch.float64, INTERP_CPU_TOL), (torch.float32, INTERP_F32_TOL)):
		maps = {d: enmap.ndmap(torch.from_numpy(x).to(d, dt), wcs) for d in (DEV, "cpu")}
		pix = {d: torch.from_numpy(enmap.sky2pix(shape, wcs, pos)).to(d) for d in (DEV, "cpu")}
		ys = {d: torch.from_numpy(y).to(d, dt) for d in (DEV, "cpu")}
		calls = [("project CAR -> CEA", lambda d: enmap.project(maps[d], cshape, cwcs).data),
			("at", lambda d: enmap.at(maps[d], pos)),
			("transpose", lambda d: interpol.map_coordinates(maps[d].data, pix[d], odata=ys[d], border="constant",
				trans=True)),
			("deriv", lambda d: interpol.map_coordinates(maps[d].data, pix[d], border="constant", deriv=True)),
			("downgrade 2", lambda d: enmap.downgrade(maps[d], 2).data),
			("submap", lambda d: maps[d].submap(box).data)]
		for label, fn in calls:
			err = relerr(fn(DEV).cpu(), fn("cpu"))
			print("interp guard %s %s (1024 x 2048): card against CPU tensors rel err %.3e (bound %.0e)" % (
				label, str(dt)[6:], err, tol))
			if not err <= tol: raise RuntimeError("interp guard %s %s: %g" % (label, dt, err))
	m64 = torch.from_numpy(x).to(DEV)
	p64 = torch.from_numpy(enmap.sky2pix(shape, wcs, pos)).to(DEV)
	y64 = torch.from_numpy(y).to(DEV)
	ax = interpol.map_coordinates(m64, p64, border="constant")
	aty = interpol.map_coordinates(m64, p64, odata=y64, border="constant", trans=True)
	lhs, rhs = float((ax*y64).sum()), float((m64*aty).sum())
	err = abs(lhs - rhs)/max(abs(lhs), abs(rhs))
	print("interp guard adjointness <A x, y> = <x, A^T y> (float64, order 3, zero border, 100000 points): rel %.3e "
		"(bound %.0e)" % (err, INTERP_ADJ_TOL))
	if not err <= INTERP_ADJ_TOL: raise RuntimeError("interp adjointness %g" % err)


def interp_phase():
	"""Guards at 1024 x 2048, then project (IQU float32 and T float64), at
	and its transpose and gradient, the resolution changes and the
	cut-outs at full width."""
	h0 = time.perf_counter()
	interp_guards()
	interp_project(torch.float64)
	interp_project(torch.float32)
	torch.cuda.empty_cache()
	m = interp_band(torch.float32, 18)
	interp_at(m)
	interp_pixel_ops(m)
	del m
	torch.cuda.empty_cache()
	print("interp phase: %.1f s" % (time.perf_counter() - h0))


# ---------------------------------------------------------------------------
# 10. healpix: BASELINE config 3 (IQU SHT + CAR -> HEALPix) and thumbnails
# ---------------------------------------------------------------------------
HP_LMAX = 2000                   # scripts/benchmark_baseline.py:104-105
HP_NSIDE = 1024
HP_RES = 180.0*60/(HP_LMAX + 2)  # arcmin: the 2002 x 4004 full-sky Fejer-1 map
HP_GUARD = (64, 128)             # nside, lmax of the guards
HP_CPU_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}      # card against CPU tensors (f32: hp_guards)
HP_RING_TOL = {torch.float64: 1e-9, torch.float32: 2e-4}      # ring against general (tests/test_science.py:256)
HP_RING_TOL_2000 = {torch.float64: 1e-9, torch.float32: 2e-3}  # the same at lmax 2000 (the f32 IQU guard there)
HP_ALM_TOL = {torch.float64: 1e-10, torch.float32: 2e-3}      # config 3's alm roundtrip (PERF.md section 2)
HP_ADJ_TOL = 1e-10               # <A x, y> = <x, A^T y>, float64, relative
HP_ROT_TOL = 1e-9                # rot= against synthesis_general at the transformed centres, float64
THUMB_NOBJ = 10_000
THUMB_R, THUMB_RES = 10.0, 0.5   # arcmin
THUMB_CHECK = 5                  # objects held against one call each, float64
HP_LAUNCHES = {}                 # launches of the healpix paths, by (kernel, mode or dtype, dtype or kind)


def hp_drive(label, fn, want, store=None, phase="healpix"):
	"""fn with every launch count set to 0 just before and read just after;
	the counts join store (HP_LAUNCHES by default), and each kernel entry in
	want (sht_cuda's or nufft_cuda's name, or a tuple of names one of which)
	must have launched. Returns fn's result."""
	from pixell_tpu_torch.ops import sht_cuda, nufft_cuda
	store = HP_LAUNCHES if store is None else store
	sht_cuda.reset_launches()
	nufft_cuda.reset_launches()
	out = fn()
	torch.cuda.synchronize()
	counts = {k: n for d in (sht_cuda.LAUNCHES_BY_DTYPE, nufft_cuda.LAUNCHES_BY_DTYPE) for k, n in d.items() if n}
	for k, n in counts.items(): store[k] = store.get(k, 0) + n
	print("%s launches in the %s: %s" % (phase, label, counts))
	missing = [w for w in want if not any(k[0] in (w if isinstance(w, tuple) else (w,)) for k in counts)]
	if missing: raise RuntimeError("%s %s: %s not launched" % (phase, label, missing))
	return out


def hp_entries(dtype, synth, anal):
	"""The Legendre entries a path in dtype must launch: the bulk synthesis
	and analysis entries named (sym / full, or a tuple of either) in dtype,
	and in float32 the float64 near-pole passes."""
	from pixell_tpu_torch.ops import sht_cuda
	tab = sht_cuda.BULK_KERNELS if dtype == torch.float32 else sht_cuda.BULK_F64
	out = [tuple(tab[x] for x in n) if isinstance(n, tuple) else tab[n] for n in synth + anal]
	if dtype == torch.float32:
		out += ["polar_synthesis"]*bool(synth) + ["polar_analysis"]*bool(anal)
	return out


def hp_count(rec, store=None):
	"""The launches of rec's kernel in the healpix paths (or those counted
	in store): its entry name (the record's name up to "["), its mode where
	it has one, its dtype for the NUFFT kernels."""
	entry, inside = rec["name"].split("[", 1)
	n = 0
	for (name, a, b), c in (HP_LAUNCHES if store is None else store).items():
		if name != entry: continue
		if name in ("u2nu_points", "nu2u_spread", "tile_keys"):
			n += c if inside.startswith(a) else 0
		elif rec.get("mode") in (None, a):
			n += c
	return n


def hp_alm(lmax, seed, dtype, device):
	"""Seeded IQU alm of a flat diagonal spectrum (spectrum(lmax, (0, 2)))."""
	from pixell_tpu_torch import curvedsky
	return curvedsky.rand_alm(spectrum(lmax, (0, 2)), lmax=lmax, seed=seed, dtype=dtype, device=device)


def hp_guards():
	"""IQU at nside 64, lmax 128 from a numpy seed: every HEALPix entry on the
	card against the same call on CPU tensors, ring against general, the
	ring synthesis's adjointness, rot= against synthesis_general."""
	from pixell_tpu_torch import reproject, curvedsky, enmap, coordinates, healpix, utils
	nside, lmax = HP_GUARD
	shape, wcs = enmap.fullsky_geometry(shape=(2*lmax + 2, 4*lmax + 4), variant="fejer1")
	a = hp_alm(lmax, 41, torch.complex128, "cpu")
	m = curvedsky.alm2map(a, enmap.zeros((3,) + shape, wcs, device="cpu"), spin=[0, 2]).data
	h = reproject.alm2map_healpix(a, nside=nside)
	rng = np.random.default_rng(42)
	coords = np.array([rng.uniform(-1.2, 1.2, 3), rng.uniform(0, 2*np.pi, 3)]).T
	kw = dict(r=5*utils.degree, res=0.5*utils.degree)
	ref64 = {}
	for dt in (torch.float64, torch.float32):
		A = {d: a.to(d, torch.complex128 if dt == torch.float64 else torch.complex64) for d in (DEV, "cpu")}
		M = {d: enmap.ndmap(m.to(d, dt), wcs) for d in (DEV, "cpu")}
		H = {d: h.to(d, dt) for d in (DEV, "cpu")}
		calls = [("alm2map_healpix ring", lambda d: reproject.alm2map_healpix(A[d], nside=nside)),
			("alm2map_healpix general", lambda d: reproject.alm2map_healpix(A[d], nside=nside, method="general")),
			("map2alm_healpix niter 0", lambda d: reproject.map2alm_healpix(H[d], lmax=lmax)),
			("map2alm_healpix niter 2", lambda d: reproject.map2alm_healpix(H[d], lmax=lmax, niter=2)),
			("map2alm_healpix general", lambda d: reproject.map2alm_healpix(H[d], lmax=lmax, method="general")),
			("healpix2map harm", lambda d: reproject.healpix2map(H[d], shape, wcs, lmax=lmax).data),
			("healpix2map spline", lambda d: reproject.healpix2map(H[d], shape, wcs, method="spline").data),
			("map2healpix harm", lambda d: reproject.map2healpix(M[d], nside=nside, lmax=lmax)),
			("map2healpix spline", lambda d: reproject.map2healpix(M[d], nside=nside, method="spline")),
			("thumbnails of 3 objects", lambda d: reproject.thumbnails(M[d], coords, **kw).data)]
		for label, fn in calls:
			got, cpu = fn(DEV).cpu(), fn("cpu")
			err = relerr(got, cpu)
			line = "healpix guard %s %s (nside %d, lmax %d, IQU): card against CPU tensors rel err %.3e" % (label,
				str(dt)[6:], nside, lmax, err)
			if dt == torch.float64:
				ref64[label] = cpu
				ok = err <= HP_CPU_TOL[dt]
				line += " (bound %.0e)" % HP_CPU_TOL[dt]
			else:
				# the card's float32 Legendre stages (the bulk kernels, float64 near the poles) and the
				# CPU's plain float32 scan are two float32 algorithms: each is held to the float64 result
				ecard, ecpu = relerr(got, ref64[label]), relerr(cpu, ref64[label])
				ok = ecard <= 2*ecpu + HP_CPU_TOL[dt]
				line += "; against float64: card %.3e, CPU %.3e (bound: card within twice the CPU's plus %.0e)" % (
					ecard, ecpu, HP_CPU_TOL[dt])
			print(line)
			if not ok: raise RuntimeError(line)
		err = relerr(calls[0][1](DEV), calls[1][1](DEV))
		print("healpix guard ring against general %s on the card: rel err %.3e (bound %.0e)" % (str(dt)[6:], err,
			HP_RING_TOL[dt]))
		if not err <= HP_RING_TOL[dt]: raise RuntimeError("healpix guard ring against general: %g" % err)
	# adjointness of the ring synthesis, float64
	x = a.to(DEV)
	y = torch.from_numpy(rng.standard_normal((3, healpix.npix(nside)))).to(DEV)
	lhs = alm_dot(reproject._alm2map_healpix_ring(x, nside, lmax, lmax, (0, 2)), y)
	rhs = alm_dot(x, reproject._healpix_ring_adjoint(y, nside, lmax, lmax, (0, 2)))
	err = abs(lhs - rhs)/max(abs(lhs), abs(rhs))
	print("healpix guard adjointness <A x, y> = <x, A^T y> of the ring synthesis (float64): rel %.3e (bound %.0e)" % (
		err, HP_ADJ_TOL))
	if not err <= HP_ADJ_TOL: raise RuntimeError("healpix adjointness %g" % err)
	# rot="gal,equ": the galactic map's I at each equatorial centre's galactic position
	got = reproject.map2healpix(enmap.ndmap(m.to(DEV), wcs), nside=nside, lmax=lmax, rot="gal,equ", method="harm")
	theta, phi = healpix.positions(nside, device=DEV)
	src = coordinates.transform("equ", "gal", torch.stack([phi, np.pi/2 - theta]))
	loc = torch.stack([np.pi/2 - src[1], torch.remainder(src[0], 2*np.pi)], -1)
	want = curvedsky.synthesis_general(x[:1], loc, lmax=lmax, spin=[0])
	err = relerr(got[:1], want)
	print("healpix guard map2healpix(rot=\"gal,equ\", method=\"harm\") I against synthesis_general at the "
		"transformed centres (float64): rel err %.3e (bound %.0e)" % (err, HP_ROT_TOL))
	if not err <= HP_ROT_TOL: raise RuntimeError("healpix rot= guard %g" % err)


def hp_config3_geometry():
	from pixell_tpu_torch import enmap, utils
	return enmap.fullsky_geometry(res=HP_RES*utils.arcmin, variant="fejer1")


def hp_config3(dtype, step_ms):
	"""Config 3 in dtype: map2alm of a seeded IQU white-noise map on the
	2002 x 4004 F1 map at lmax 2000, alm2map_healpix at nside 1024, alm2map
	back; guards, the step's time, stages, busy share, launches, peak."""
	from pixell_tpu_torch import enmap, curvedsky, reproject
	from pixell_tpu_torch.ops import sht_cuda
	tag = str(dtype)[6:]
	shape, wcs = hp_config3_geometry()
	ainfo = curvedsky.alm_info(lmax=HP_LMAX)
	gen = torch.Generator(device=DEV)
	gen.manual_seed(33)
	arr = torch.randn((3,) + tuple(shape), generator=gen, device=DEV, dtype=dtype)
	def analyse(x):
		return curvedsky.map2alm(enmap.ndmap(x, wcs), lmax=HP_LMAX, spin=[0, 2])
	def step():
		alm = analyse(arr)
		heal = reproject.alm2map_healpix(alm, nside=HP_NSIDE, spin=[0, 2])
		omap = curvedsky.alm2map(alm, enmap.zeros((3,) + tuple(shape), wcs, dtype, device=DEV), spin=[0, 2],
			ainfo=ainfo)
		return alm, heal, omap.data
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	alm, heal, omap = hp_drive("config 3 step %s" % tag, step, hp_entries(dtype, ["sym_synthesis",
		"full_synthesis"], [("sym_analysis", "full_analysis")]))
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	counts = {k: n for k, n in sht_cuda.LAUNCHES_BY_DTYPE.items() if n}
	npix = 12*HP_NSIDE**2
	ok = tuple(heal.shape) == (3, npix) and tuple(omap.shape) == (3,) + tuple(shape) and \
		bool(torch.isfinite(heal).all()) and bool(torch.isfinite(omap).all())
	if not ok: raise RuntimeError("config 3 %s: outputs %s, %s not finite or of the wrong shape" % (tag,
		tuple(heal.shape), tuple(omap.shape)))
	aerr = relerr(analyse(omap), alm)
	print("healpix config 3 %s: %s map -> lmax %d -> nside %d (%d pixels) and back; alm roundtrip rel err %.3e "
		"(bound %.0e); peak device memory %.2f GiB (bound %d); Legendre launches in a step %s" % (tag, (3,) +
		tuple(shape), HP_LMAX, HP_NSIDE, npix, aerr, HP_ALM_TOL[dtype], peak, FLAT_MEM_GIB, counts))
	if not aerr <= HP_ALM_TOL[dtype]: raise RuntimeError("config 3 %s: alm roundtrip %g" % (tag, aerr))
	if not peak < FLAT_MEM_GIB: raise RuntimeError("config 3 %s: peak %.2f GiB" % (tag, peak))
	# the HEALPix synthesis alone: its launches, and the ring path against the general one
	hp_drive("alm2map_healpix ring %s" % tag, lambda: reproject.alm2map_healpix(alm, nside=HP_NSIDE),
		hp_entries(dtype, ["full_synthesis"], []))
	gen_heal = hp_drive("alm2map_healpix general %s" % tag, lambda: reproject.alm2map_healpix(alm,
		nside=HP_NSIDE, method="general"), ["u2nu_points"])
	err = relerr(heal, gen_heal)
	del gen_heal
	print("healpix config 3 %s: alm2map_healpix ring against general at nside %d rel err %.3e (bound %.0e)" % (
		tag, HP_NSIDE, err, HP_RING_TOL_2000[dtype]))
	if not err <= HP_RING_TOL_2000[dtype]: raise RuntimeError("config 3 %s: ring against general %g" % (tag, err))
	del heal, omap
	torch.cuda.empty_cache()
	med, lo, hi = flat_time(step, 1, 7)
	step_ms[dtype] = med
	print("healpix config 3 %s: %.3f ms a step (median of 7; min %.3f, max %.3f)" % (tag, med, lo, hi))
	# the stages
	_, _, w, beta = reproject._ring_params(alm.dtype)
	geom = reproject._hpix_ring_geom(HP_NSIDE, HP_LMAX, w, np.float32 if dtype == torch.float32 else np.float64,
		DEV)
	G, _ = reproject._phases(alm, HP_LMAX, HP_LMAX, (0, 2), False, geom)
	from pixell_tpu_torch import fft as enfft
	corr = enfft._correction_on(geom.N, w, beta, dtype, DEV)[:HP_LMAX+1]
	wx = reproject._es_taps(geom, w, beta)
	zeros = enmap.zeros((3,) + tuple(shape), wcs, dtype, device=DEV)
	stages = [("map2alm", lambda: analyse(arr)),
		("HEALPix Legendre (synthesis_phase, %d rings)" % geom.nring,
			lambda: reproject._phases(alm, HP_LMAX, HP_LMAX, (0, 2), False, geom)),
		("HEALPix belt (%d rings x %d)" % (geom.nbelt, 4*HP_NSIDE), lambda: reproject._belt_synthesis(G, geom,
			HP_NSIDE)),
		("HEALPix caps (%d rings, N %d, w %d, %d pixels)" % (geom.ncap, geom.N, w, geom.start.numel()),
			lambda: reproject._cap_gather(reproject._cap_fine(G, geom, corr, w), geom, wx)),
		("alm2map", lambda: curvedsky.alm2map(alm, zeros, spin=[0, 2], ainfo=ainfo))]
	for name, fn in stages:
		smed, slo, shi = flat_time(fn, 1, 3)
		print("healpix config 3 %s: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (tag, name, smed, slo,
			shi))
	# the cap gather and its transpose against their bytes bounds
	fine = reproject._cap_fine(G, geom, corr, w)
	del G
	esize = torch.finfo(dtype).bits//8
	npt = geom.start.numel()
	capv = reproject._cap_gather(fine, geom, wx)
	tables = npt*(8 + esize)   # the first tap's index and the fraction, a pixel
	for name, fn, nb in [("cap gather", lambda: reproject._cap_gather(fine, geom, wx),
			fine.numel()*esize + tables + capv.numel()*esize),
			("cap gather transpose (index_add_)", lambda: reproject._cap_gather_t(capv, geom, wx),
			capv.numel()*esize + tables + fine.numel()*esize)]:
		smed, slo, shi = flat_time(fn, 1, 3)
		b = 1e3*nb/PEAK_BYTES
		print("healpix config 3 %s: %s %.3f ms (median of 3; min %.3f, max %.3f), bytes bound %.3f ms (%.2f %% of "
			"it; %.3f GB), %.1f %% of the step" % (tag, name, smed, slo, shi, b, 100*b/smed, nb/1e9,
			100*smed/med))
	del fine, capv, wx, zeros
	torch.cuda.empty_cache()
	wall, busy = flat_profile(step, 14, "healpix config 3 %s step" % tag)
	print("healpix config 3 %s: device busy %.1f %% of one profiled step" % (tag, 100*busy/wall))
	return alm


def hp_extras(alm, dtype):
	"""At nside 1024, IQU, lmax 2000: the ring and the general synthesis
	timed, map2alm_healpix (niter 0 and 3), healpix2map ("harm", onto the
	2002 x 4004 map) and map2healpix ("spline", wrapped border)."""
	from pixell_tpu_torch import enmap, curvedsky, reproject
	tag = str(dtype)[6:]
	shape, wcs = hp_config3_geometry()
	heal = reproject.alm2map_healpix(alm, nside=HP_NSIDE)
	cmap = curvedsky.alm2map(alm, enmap.zeros((3,) + tuple(shape), wcs, dtype, device=DEV), spin=[0, 2])
	calls = [("alm2map_healpix ring", lambda: reproject.alm2map_healpix(alm, nside=HP_NSIDE), []),
		("alm2map_healpix general", lambda: reproject.alm2map_healpix(alm, nside=HP_NSIDE, method="general"),
			["u2nu_points"]),
		("map2alm_healpix niter 0", lambda: reproject.map2alm_healpix(heal, lmax=HP_LMAX),
			hp_entries(dtype, [], ["full_analysis"])),
		("map2alm_healpix niter 3", lambda: reproject.map2alm_healpix(heal, lmax=HP_LMAX, niter=3),
			hp_entries(dtype, ["full_synthesis"], ["full_analysis"])),
		("healpix2map harm onto %dx%d" % tuple(shape), lambda: reproject.healpix2map(heal, shape, wcs,
			lmax=HP_LMAX), hp_entries(dtype, ["sym_synthesis"], ["full_analysis"])),
		("map2healpix spline, wrapped border", lambda: reproject.map2healpix(cmap, nside=HP_NSIDE,
			method="spline", boundary="wrap"), [])]
	for label, fn, want in calls:
		r = hp_drive("%s %s" % (label, tag), fn, want)
		r = r.data if isinstance(r, enmap.ndmap) else r
		if not bool(torch.isfinite(r).all()): raise RuntimeError("healpix %s %s: not finite" % (label, tag))
		del r
		med, lo, hi = flat_time(fn, 1, 3)
		print("healpix %s IQU %s, nside %d, lmax %d: %.3f ms (median of 3; min %.3f, max %.3f)" % (label, tag,
			HP_NSIDE, HP_LMAX, med, lo, hi))
		torch.cuda.empty_cache()
	a0 = reproject.map2alm_healpix(heal, lmax=HP_LMAX, niter=3)
	err = relerr(a0, alm)
	print("healpix map2alm_healpix niter 3 %s: alm back rel err %.3e (the pixel window of the ring synthesis "
		"at lmax %d, nside %d: no exact quadrature)" % (tag, err, HP_LMAX, HP_NSIDE))


def hp_thumbnails():
	"""thumbnails of the IQU float32 DR6-sized band around THUMB_NOBJ objects
	drawn uniformly in it (r THUMB_R, res THUMB_RES arcmin, order 3, with
	polarization): time, stages, busy share; THUMB_CHECK objects in float64
	batched against one call each."""
	from pixell_tpu_torch import reproject, enmap, interpol, utils
	m = interp_band(torch.float32, 24)
	rng = np.random.default_rng(25)
	coords = np.array([rng.uniform(-63, 23, THUMB_NOBJ), rng.uniform(-180, 180, THUMB_NOBJ)]).T*utils.degree
	kw = dict(r=THUMB_R*utils.arcmin, res=THUMB_RES*utils.arcmin)
	th = reproject.thumbnails(m, coords, **kw)
	if th.shape[:2] != (THUMB_NOBJ, 3) or not bool(torch.isfinite(th.data).all()):
		raise RuntimeError("thumbnails: %s not finite or of the wrong shape" % (tuple(th.shape),))
	med, lo, hi = flat_time(lambda: reproject.thumbnails(m, coords, **kw), 1, 3)
	print("healpix thumbnails of %s IQU float32, %d objects, %s stamps (r %.1f', res %.1f', order 3, pol): %.3f "
		"ms (median of 3; min %.3f, max %.3f)" % (tuple(m.shape), THUMB_NOBJ, tuple(th.shape[-2:]), THUMB_R,
		THUMB_RES, med, lo, hi))
	oshape, owcs = enmap.thumbnail_geometry(**kw)
	opos = enmap._posmap_np(oshape, owcs, safe=False).reshape(2, -1)
	pos, ang = reproject._recentered(coords, opos, True, DEV)
	pix = enmap._sky2pix_on(m.shape, m.wcs, pos.reshape(2, -1))
	data = m.data
	vals = th.data
	stages = [("positions (recentering and sky2pix on the card)", lambda: enmap._sky2pix_on(m.shape, m.wcs,
			reproject._recentered(coords, opos, True, DEV)[0].reshape(2, -1))),
		("prefilter", lambda: interpol._coefficients(data, "spline", 3, "constant", True)),
		("gather", lambda: interpol.map_coordinates(data, pix, order=3, border="constant", prefilter=False)),
		("rotation", lambda: enmap.rotate_pol(vals, -ang.reshape((THUMB_NOBJ,) + tuple(oshape[-2:]))))]
	for name, fn in stages:
		smed, slo, shi = flat_time(fn, 1, 3)
		print("healpix thumbnails: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (name, smed, slo, shi))
	del pos, ang, pix, vals, th
	torch.cuda.empty_cache()
	wall, busy = flat_profile(lambda: reproject.thumbnails(m, coords, **kw), 12, "healpix thumbnails")
	print("healpix thumbnails: device busy %.1f %% of one profiled call" % (100*busy/wall))
	# batched against one call each, in float64: THUMB_CHECK objects of a 4-degree strip, on the band's rows
	# within 2 degrees of it (a float64 IQU copy of the whole band and its prefilter would take ~70 GiB)
	strip = np.nonzero((coords[:, 0] > -10*utils.degree) & (coords[:, 0] < -6*utils.degree))[0][:THUMB_CHECK]
	ys = enmap.sky2pix(m.shape, m.wcs, np.array([[-12, -4], [0, 0]])*utils.degree)[0]
	y0, y1 = int(np.floor(ys.min())), int(np.ceil(ys.max())) + 1
	m64 = enmap.ndmap(m.data[:, y0:y1].double(), enmap.slice_geometry(m.shape, m.wcs, (slice(y0, y1),
		slice(None)))[1])
	del m
	torch.cuda.empty_cache()
	sub = coords[strip]
	batch = reproject.thumbnails(m64, sub, **kw).data
	err = max(relerr(batch[i], reproject.thumbnails(m64, sub[i], **kw).data[0]) for i in range(len(sub)))
	print("healpix thumbnails float64: %d objects batched against one call each, rel err %.3e (bound 1e-12; %s "
		"map)" % (len(sub), err, tuple(m64.shape)))
	if len(sub) < THUMB_CHECK or not err <= 1e-12:
		raise RuntimeError("thumbnails: %d objects, batch against single calls %g" % (len(sub), err))
	del m64
	torch.cuda.empty_cache()


def healpix_phase():
	"""Guards at nside 64, config 3 in float32 and float64 with its stages,
	the other HEALPix entries at nside 1024, and the thumbnails."""
	h0 = time.perf_counter()
	HP_LAUNCHES.clear()
	hp_guards()
	step_ms = {}
	for dt in (torch.float32, torch.float64):
		alm = hp_config3(dt, step_ms)
		hp_extras(alm, dt)
		del alm
		torch.cuda.empty_cache()
	hp_thumbnails()
	print("healpix launches in all its paths (each driven with the counts at 0): %s" % HP_LAUNCHES)
	print("healpix phase: %.1f s" % (time.perf_counter() - h0))


# ---------------------------------------------------------------------------
# 11. lensing: BASELINE config 4 (curved-sky lensing, then Doppler aberration)
# ---------------------------------------------------------------------------
LENS_LMAX = 4000                           # scripts/benchmark_baseline.py:131-137
LENS_BOX = np.array([[-5, 10], [5, -10]])  # degrees, the same
LENS_RES = 0.5                             # arcmin
LENS_DTHETA = 2.0                          # degrees: the point stage's dec bands (:158-159)
LENS_GUARD = (64, 10.0, 0.5)               # lmax, half side and res in degrees: the guards' 40 x 40 patch
LENS_CPU_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}   # card against CPU tensors (f32: lens_guards)
# the lensed map in float64, card against CPU tensors: a tenth of the NUFFT's epsilon 1e-10. The fine grid
# divides the torus's coefficients by the ES kernel's transform, small near the band edge, and so magnifies
# the two devices' torus synthesis differences (~1e-14) about a hundredfold (1.6e-12 at lmax 64)
LENS_NUFFT_CPU_TOL = 1e-11
LENS_F32_TOL = 5e-3        # config 4's float32 lensed map against the float64 one, of the largest value
LENS_DIRECT_TOL = 1e-8     # float64 lensed pixels against a direct sum at the displaced positions
LENS_ZERO_TOL = 1e-9       # zero phi_alm: lensed against unlensed, float64 (ten times the NUFFT's epsilon, as GEN_TOL)
LENS_NDIRECT = 512         # pixels held against the direct sum
LENS_SOLVE_TOL = 1e-5      # iu2nu's grid against the one that made the samples, float64
LENS_LAUNCHES = {}         # launches of the lensing paths, by (kernel, mode or dtype, dtype or kind)


def lens_spectra(lmax):
	"""Config 4's [phi, T, E, B] spectra (scripts/benchmark_baseline.py:138-143)."""
	ps = np.zeros((4, 4, lmax + 1))
	l = np.arange(lmax + 1)
	ps[0, 0] = 1e-8/np.maximum(l*(l + 1), 1)**2
	ps[1, 1] = 1.0/np.maximum(l, 1)**2
	ps[2, 2] = 0.1/np.maximum(l, 1)**2
	ps[3, 3] = 0.01/np.maximum(l, 1)**2
	return ps


def lens_drive(label, fn, want):
	"""hp_drive into LENS_LAUNCHES, with the NUFFT bins' cache emptied
	first, so that every path bins its points through K12."""
	from pixell_tpu_torch.ops import nufft_cuda
	nufft_cuda.clear_bins()
	return hp_drive(label, fn, want, LENS_LAUNCHES, "lensing")


def lens_guards():
	"""On the 40 x 40 CAR patch at 0.5 degrees, lmax 64, IQU, inputs from a
	numpy seed: lens_map_curved ("lupka", unbanded and in bands),
	lens_map_flat, delens_map, boost_map (thermo, dipole), shift_interp,
	inufft, nufft_adjoint and iu2nu (300 points, an 8 x 10 grid), each on
	the card against the same call on CPU tensors: float64 within 1e-12 of
	the largest value (the lensed map within LENS_NUFFT_CPU_TOL); float32 each side against the CPU's float64 result,
	the card's error within twice the CPU's plus 2e-5. Returns the failed
	guards' lines (lensing_phase raises on them at its end)."""
	from pixell_tpu_torch import lensing, aberration, enmap, fft, utils
	lmax, half, res = LENS_GUARD
	shape, wcs = enmap.geometry(pos=np.array([[-half, half], [half, -half]])*utils.degree, res=res*utils.degree,
		proj="car")
	phi, cmb = lensing.rand_alm(lens_spectra(lmax), lmax=lmax, seed=51, device="cpu")
	rng = np.random.default_rng(52)
	m = rng.standard_normal((3,) + tuple(shape))
	phimap = 1e-6*rng.standard_normal(tuple(shape))
	grad = 0.3*res*utils.degree*rng.standard_normal((2,) + tuple(shape))
	dy, dx = rng.uniform(-2, 2, (2,) + tuple(shape))
	g = rng.standard_normal((8, 10)) + 1j*rng.standard_normal((8, 10))
	inds, inds2 = rng.uniform(0, 2*np.pi, (2, 60)), rng.uniform(0, 2*np.pi, (2, 300))
	v = rng.standard_normal(60) + 1j*rng.standard_normal(60)
	samples = fft.u2nu(torch.from_numpy(g), torch.from_numpy(inds2.T.copy()), device="cpu").numpy()
	ref64, failed = {}, []
	for dt in (torch.float64, torch.float32):
		ct = torch.complex128 if dt == torch.float64 else torch.complex64
		w, beta = fft._es_params(1e-10)   # shift_interp's kernel, the same in both dtypes
		on = lambda x, t: {d: torch.from_numpy(np.asarray(x)).to(d, t) for d in (DEV, "cpu")}
		P, C = on(phi, ct), on(cmb, ct)
		M = {d: enmap.ndmap(x, wcs) for d, x in on(m, dt).items()}
		PHI = {d: enmap.ndmap(x, wcs) for d, x in on(phimap, dt).items()}
		G, DY, DX = on(grad, dt), on(dy, torch.float64), on(dx, torch.float64)
		GC, V, I, I2, A = on(g, ct), on(v, ct), on(inds, torch.float64), on(inds2, torch.float64), on(samples, ct)
		kw = dict(shape=(3,) + tuple(shape), wcs=wcs, dtype=dt, output="lupka")
		calls = [("lens_map_curved lupka", lambda d: lensing.lens_map_curved(phi_alm=P[d], cmb_alm=C[d], **kw),
				["u2nu_points", "tile_keys"]),
			("lens_map_curved lupka in bands of 4 degrees", lambda d: lensing.lens_map_curved(phi_alm=P[d],
				cmb_alm=C[d], delta_theta=4*utils.degree, **kw), ["u2nu_points", "tile_keys"]),
			("lens_map_flat", lambda d: lensing.lens_map_flat(M[d], PHI[d]), []),
			("delens_map", lambda d: lensing.delens_map(M[d], G[d]), []),
			("boost_map thermo dipole", lambda d: aberration.boost_map(M[d], modulation="thermo", dipole=True), []),
			("shift_interp w %d" % w, lambda d: fft.shift_interp(M[d].data, DY[d], DX[d], 2, w, beta),
				["u2nu_points"]),
			("inufft", lambda d: fft.inufft(GC[d], I[d]), ["u2nu_points"]),
			("nufft_adjoint", lambda d: fft.nufft_adjoint(V[d], I[d], oshape=(8, 10)), ["nu2u_spread"]),
			("iu2nu", lambda d: fft.iu2nu(A[d], I2[d], oshape=(8, 10)), ["u2nu_points", "nu2u_spread"])]
		for label, fn, want in calls:
			outs = lens_drive("guard %s %s" % (label, str(dt)[6:]), lambda: fn(DEV), want)
			cpus = fn("cpu")
			if not isinstance(outs, tuple): outs, cpus = (outs,), (cpus,)
			for i, (got, cpu) in enumerate(zip(outs, cpus)):
				got, cpu = [x.data if isinstance(x, enmap.ndmap) else x for x in (got, cpu)]
				got = got.cpu()
				name = "%s%s" % (label, "" if len(outs) == 1 else " " + "lupka"[i])
				err = relerr(got, cpu)
				line = "lensing guard %s %s (lmax %d, %s): card against CPU tensors rel err %.3e" % (name,
					str(dt)[6:], lmax, tuple(shape), err)
				if dt == torch.float64:
					ref64[name] = cpu
					tol = LENS_NUFFT_CPU_TOL if name.startswith("lens_map_curved") and name.endswith(" l") \
						else LENS_CPU_TOL[dt]
					ok = err <= tol
					line += " (bound %.0e)" % tol
				else:
					ecard, ecpu = relerr(got, ref64[name]), relerr(cpu, ref64[name])
					ok = ecard <= 2*ecpu + LENS_CPU_TOL[dt]
					line += "; against float64: card %.3e, CPU %.3e (bound: card within twice the CPU's plus " \
						"%.0e)" % (ecard, ecpu, LENS_CPU_TOL[dt])
				print(line)
				if not ok: failed.append(line)
	err = relerr(ref64["iu2nu"], torch.from_numpy(g))
	print("lensing guard iu2nu float64: the grid back from its 300 samples, rel err %.3e (bound %.0e)" % (err,
		LENS_SOLVE_TOL))
	if not err <= LENS_SOLVE_TOL: failed.append("lensing guard iu2nu: %g" % err)
	# where the float64 card and CPU part: the torus synthesis, by ring
	from pixell_tpu_torch import curvedsky, sht
	Nt, Np = curvedsky._torus_shape(lmax, lmax)
	th = curvedsky._torus_theta(Nt)
	tor = {d: sht.synthesis(cmb.to(d), th, Np, phi0=0.0, lmax=lmax, mmax=lmax, spin=[0, 2],
		map_dtype=torch.float64).cpu() for d in (DEV, "cpu")}
	by_ring = ((tor[DEV] - tor["cpu"]).abs().amax((0, 2))/tor["cpu"].abs().max()).numpy()
	print("lensing guard torus synthesis float64 (lmax %d, %d rings): card against CPU rel err %.3e; by ring, the "
		"largest at theta %s: %s; without the 3 rings at each pole %.3e" % (lmax, len(th), by_ring.max(),
		np.round(th[np.argsort(by_ring)[-4:]], 4), by_ring[np.argsort(by_ring)[-4:]], by_ring[3:-3].max()))
	return failed


def lens_config4_geometry():
	from pixell_tpu_torch import enmap, utils
	return enmap.geometry(pos=LENS_BOX*utils.degree, res=LENS_RES*utils.arcmin, proj="car")


def lens_step_fn(phi, cmb, dtype):
	"""Config 4's step: lens_map_curved of IQU in dec bands of LENS_DTHETA,
	then boost_map(modulation=None)."""
	from pixell_tpu_torch import lensing, aberration, utils
	shape, wcs = lens_config4_geometry()
	def step():
		lensed = lensing.lens_map_curved(shape=(3,) + tuple(shape), wcs=wcs, phi_alm=phi, cmb_alm=cmb,
			dtype=dtype, delta_theta=LENS_DTHETA*utils.degree)
		return aberration.boost_map(lensed, modulation=None)
	return step


def lens_share(label, ms, nbytes, step_ms):
	b = 1e3*nbytes/PEAK_BYTES
	print("lensing %s: %.3f ms, bytes bound %.3f ms (%.2f %% of it; %.3f GB), %.1f %% of the step" % (label, ms,
		b, 100*b/ms, nbytes/1e9, 100*ms/step_ms))


def lens_stages(phi, cmb, dtype, step_ms):
	"""The step's stages (median of 3, CUDA events): the gradient SHT, the
	plan build (the torus synthesis alone beside it), the band loop (the
	positions and offsets, the binning, the evaluation, the rotation), the
	aberration (the Aberrator's construction, once per geometry; the cached
	positions; the prefilter, the gather, the rotation) and the modulation;
	the plain-torch stages against their bytes bounds."""
	from pixell_tpu_torch import lensing, aberration, curvedsky, enmap, sht, interpol, utils
	from pixell_tpu_torch.ops import nufft_cuda
	tag = str(dtype)[6:]
	shape, wcs = lens_config4_geometry()
	shape = tuple(shape)
	npix = shape[0]*shape[1]
	esize = torch.finfo(dtype).bits//8
	def stage(name, fn, nbytes=None):
		med, lo, hi = flat_time(fn, 1, 3)
		print("lensing config 4 %s: stage %s %.3f ms (median of 3; min %.3f, max %.3f)" % (tag, name, med, lo, hi))
		if nbytes is not None: lens_share("config 4 %s %s" % (tag, name), med, nbytes, step_ms)
		return med
	zeros2 = enmap.zeros((2,) + shape, wcs, dtype, device=DEV)
	stage("gradient SHT (deriv alm2map, %d rings)" % shape[0], lambda: curvedsky.alm2map(phi, zeros2, deriv=True))
	grad = curvedsky.alm2map(phi, zeros2, deriv=True).data
	Nt, Np = curvedsky._torus_shape(LENS_LMAX, LENS_LMAX)
	stage("plan build (torus synthesis, FFT, fine grid)", lambda: curvedsky.SynthesisPlan(cmb, lmax=LENS_LMAX,
		spin=[0, 2]))
	stage("  of it the torus synthesis (%d rings x %d)" % (Nt//2 + 1, Np), lambda: sht.synthesis(cmb,
		curvedsky._torus_theta(Nt), Np, phi0=0.0, lmax=LENS_LMAX, mmax=LENS_LMAX, spin=[0, 2], map_dtype=dtype))
	splan = curvedsky.SynthesisPlan(cmb, lmax=LENS_LMAX, spin=[0, 2])
	bsize = lensing._band_size(shape[0], wcs, LENS_DTHETA*utils.degree)
	bands = list(lensing._bands(shape[0], bsize))
	axes = lensing._pos_axes(shape, wcs, DEV)
	stage("band loop (%d bands of %d rows)" % (len(bands), bsize), lambda: lensing._lens_bands(splan, grad, wcs,
		bsize, True, True, True, dtype))
	def positions():
		return [lensing._band_points(grad[:, i1:i2], lensing._band_positions(wcs, shape, i1, i2, DEV, axes),
			True, True) for i1, i2, _ in bands]
	pts = positions()
	npt = sum(p[0].shape[0] for p in pts)
	# grad read, loc and cos / sin written, float64 positions
	pos_ms = stage("  positions and offsets", positions, npt*(2*esize + 32))
	up = splan.uplan
	def binning():
		nufft_cuda.clear_bins()
		for loc, _ in pts: nufft_cuda.bins(loc, up.nfine, (2*np.pi, 2*np.pi), up.w, dtype)
	stage("  binning (K12 keys, sort, subproblems)", binning)
	stage("  evaluation (binning and K10)", lambda: [splan.eval(loc) for loc, _ in pts])
	vals = [splan.eval(loc).reshape(3, -1, shape[1]) for loc, _ in pts]
	rot_ms = stage("  rotation", lambda: [lensing._rotate_band(v, o) for v, (_, o) in zip(vals, pts)],
		npt*6*esize)
	lens_share("config 4 %s positions, offsets and rotation" % tag, pos_ms + rot_ms, npt*(8*esize + 32), step_ms)
	del vals, pts, splan
	torch.cuda.empty_cache()
	lensed = lensing.lens_map_curved(shape=(3,) + shape, wcs=wcs, phi_alm=phi, cmb_alm=cmb, dtype=dtype,
		delta_theta=LENS_DTHETA*utils.degree)
	h0 = time.perf_counter()
	ab = aberration.Aberrator(lensed.shape, wcs, device=DEV)
	torch.cuda.synchronize()
	print("lensing config 4 %s: Aberrator construction (once per geometry: positions, deflect and its angle "
		"on the card in float64) %.3f ms" % (tag, 1e3*(time.perf_counter() - h0)))
	stage("aberration (boost_map, modulate=False, operator cached)", lambda: aberration.boost_map(lensed,
		modulation=None, modulate=False))
	stage("  positions from the cache", lambda: ab._cached(dtype))
	pix, c2, s2 = ab._cached(dtype)
	data = lensed.data
	stage("  prefilter", lambda: interpol._coefficients(data, "spline", 3, "cyclic", True), 6*esize*npix)
	coef = interpol._coefficients(data, "spline", 3, "cyclic", True)[0]
	stage("  gather", lambda: interpol.map_coordinates(coef, pix, order=3, border="cyclic", prefilter=False),
		8*esize*npix)
	res = interpol.map_coordinates(coef, pix, order=3, border="cyclic", prefilter=False)
	def rotate():
		q, u = res[-2], res[-1]
		res[-2], res[-1] = c2*q - s2*u, s2*q + c2*u
	stage("  rotation", rotate, 6*esize*npix)
	stage("modulation (boost_map, aberrate=False)", lambda: aberration.boost_map(lensed, modulation=None,
		aberrate=False), 7*esize*npix)
	del lensed, coef, res, ab, grad, zeros2
	torch.cuda.empty_cache()


def lens_direct(phi, cmb, lensed, grad):
	"""The float64 lensed map at LENS_NDIRECT seeded pixels against a direct
	sum of cmb at their displaced positions (offset_by_grad on the CPU in
	float64, the gradient the card's), Q and U rotated by the parallel
	transport."""
	from pixell_tpu_torch import lensing, enmap
	shape, wcs = lens_config4_geometry()
	rng = np.random.default_rng(53)
	iy, ix = rng.integers(0, shape[0], LENS_NDIRECT), rng.integers(0, shape[1], LENS_NDIRECT)
	dec, ra = enmap.posaxes(shape, wcs, safe=False)
	pos = np.array([dec[iy], ra[ix]])
	g = grad[:, iy, ix].cpu().numpy()
	opos = lensing.offset_by_grad(pos, g, pol=True)
	loc = torch.from_numpy(np.stack([np.pi/2 - opos[0], opos[1]], -1)).to(DEV)
	want = direct_sum(cmb, loc, LENS_LMAX, (0, 2))
	c2, s2 = (torch.from_numpy(x).to(DEV) for x in opos[2:])
	want = torch.stack([want[0], c2*want[1] - s2*want[2], s2*want[1] + c2*want[2]])
	err = relerr(lensed[:, iy, ix], want)
	print("lensing config 4 float64: %d lensed pixels against a direct sum at their displaced positions rel err "
		"%.3e (bound %.0e); deflection rms %.3f arcmin" % (LENS_NDIRECT, err, LENS_DIRECT_TOL,
		float(grad.square().sum(0).mean().sqrt())/np.pi*180*60))
	if not err <= LENS_DIRECT_TOL: raise RuntimeError("lensing direct sum %g" % err)


def lens_config4(phi128, cmb128):
	"""Config 4 in float32 and float64: guards, the step's time, stages,
	busy share, launches and memory peak."""
	from pixell_tpu_torch import lensing, utils
	shape, wcs = lens_config4_geometry()
	lensed = {}
	for dtype in (torch.float32, torch.float64):
		tag = str(dtype)[6:]
		ct = torch.complex64 if dtype == torch.float32 else torch.complex128
		phi, cmb = phi128.to(ct), cmb128.to(ct)
		step = lens_step_fn(phi, cmb, dtype)
		want = hp_entries(dtype, [("sym_synthesis", "full_synthesis"), "full_synthesis"], []) + ["u2nu_points",
			"tile_keys"]
		torch.cuda.synchronize()
		torch.cuda.reset_peak_memory_stats()
		out = lens_drive("config 4 step %s" % tag, step, want)
		torch.cuda.synchronize()
		peak = torch.cuda.max_memory_allocated()/2**30
		ok = tuple(out.shape) == (3,) + tuple(shape) and out.dtype == dtype and bool(torch.isfinite(out.data).all())
		print("lensing config 4 %s: %s IQU, lmax %d, bands of %.1f degrees, then boost_map: output %s %s; peak "
			"device memory %.2f GiB (bound %d)" % (tag, tuple(shape), LENS_LMAX, LENS_DTHETA, tuple(out.shape),
			out.dtype, peak, FLAT_MEM_GIB))
		if not ok: raise RuntimeError("lensing config 4 %s: output not finite or of the wrong shape" % tag)
		if not peak < FLAT_MEM_GIB: raise RuntimeError("lensing config 4 %s: peak %.2f GiB" % (tag, peak))
		del out
		med, lo, hi = flat_time(step, 1, 7)
		print("lensing config 4 %s: %.3f ms a step (median of 7; min %.3f, max %.3f)" % (tag, med, lo, hi))
		lens_stages(phi, cmb, dtype, med)
		wall, busy = flat_profile(step, 16, "lensing config 4 %s step" % tag)
		print("lensing config 4 %s: device busy %.1f %% of one profiled step" % (tag, 100*busy/wall))
		out = lensing.lens_map_curved(shape=(3,) + tuple(shape), wcs=wcs, phi_alm=phi, cmb_alm=cmb, dtype=dtype,
			delta_theta=LENS_DTHETA*utils.degree, output="la")
		lensed[dtype] = out
		del phi, cmb, step
		torch.cuda.empty_cache()
	(l32, _), (l64, grad64) = lensed[torch.float32], lensed[torch.float64]
	err = relerr(l32.data, l64.data)
	print("lensing config 4: float32 lensed map against float64 rel err %.3e (bound %.0e)" % (err, LENS_F32_TOL))
	if not err <= LENS_F32_TOL: raise RuntimeError("lensing config 4 float32 against float64 %g" % err)
	lens_direct(phi128, cmb128, l64.data, grad64.data)
	del lensed, l32, l64, grad64
	zero = lensing.lens_map_curved(shape=(3,) + tuple(shape), wcs=wcs, phi_alm=phi128*0, cmb_alm=cmb128,
		delta_theta=LENS_DTHETA*utils.degree, output="lu")
	err = relerr(zero[0].data, zero[1].data)
	print("lensing config 4 float64: zero phi_alm, lensed against unlensed rel err %.3e (bound %.0e)" % (err,
		LENS_ZERO_TOL))
	if not err <= LENS_ZERO_TOL: raise RuntimeError("lensing zero phi %g" % err)
	del zero
	torch.cuda.empty_cache()


def lensing_phase():
	"""The guards on a small patch, then config 4 at full size in float32
	and float64."""
	from pixell_tpu_torch import lensing
	h0 = time.perf_counter()
	LENS_LAUNCHES.clear()
	failed = lens_guards()
	t0 = time.perf_counter()
	phi, cmb = lensing.rand_alm(lens_spectra(LENS_LMAX), lmax=LENS_LMAX, seed=1, device=DEV)
	torch.cuda.synchronize()
	print("lensing config 4: rand_alm at lmax %d (host numpy draws, then on the card) %.1f s" % (LENS_LMAX,
		time.perf_counter() - t0))
	lens_config4(phi, cmb)
	del phi, cmb
	torch.cuda.empty_cache()
	print("lensing launches in all its paths (each driven with the counts at 0): %s" % LENS_LAUNCHES)
	print("lensing phase: %.1f s" % (time.perf_counter() - h0))
	if failed: raise RuntimeError("lensing guards failed:\n" + "\n".join(failed))


# ---------------------------------------------------------------------------
# 12. config5: BASELINE config 5 (point sources, then wavelets)
# ---------------------------------------------------------------------------
C5_LMAX = 10000            # scripts/benchmark_baseline.py:172-236
C5_NSRC = 10_000
C5_GUARD = (64, 200)       # lmax and sources of the card-against-CPU guard, on the smallest F1 grid
C5_ID_TOL = 1e-9           # f64 wave2map(map2wave(m)) against harm2map(sum_i k_i^2 map2harm(m)), of the largest value
C5_F32_TOL = 5e-3          # the f32 reconstruction against the f64 one (config 4's bound)
C5_CPU_TOL = 1e-12         # card f64 against CPU f64, the whole chain at C5_GUARD
C5_LAUNCHES = {}           # launches of the config-5 paths, by (kernel, mode, dtype)


def c5_geometry(lmax):
	"""The smallest full-sky F1 grid with at least lmax + 2 rings and a
	2357-smooth column count (scripts/benchmark_baseline.py:180-185)."""
	from pixell_tpu_torch import enmap, utils
	from pixell_tpu_torch import fft as enfft
	ny = lmax + 2
	while enfft.fft_len(2*ny, "above") != 2*ny: ny += 1
	return enmap.fullsky_geometry(res=180.0*60/ny*utils.arcmin, variant="fejer1")


def c5_catalogue(nsrc):
	"""Config 5's sources: dec uniform in +-1.2 rad, RA in +-pi, amplitudes
	0.5-2 (float32), a 2' Gaussian profile on 1000 radii out to 30'."""
	from pixell_tpu_torch import utils
	rng = np.random.default_rng(0)
	poss = np.array([rng.uniform(-1.2, 1.2, nsrc), rng.uniform(-np.pi, np.pi, nsrc)])
	amps = rng.uniform(0.5, 2.0, nsrc).astype(np.float32)
	r = np.linspace(0, 30*utils.arcmin, 1000)
	return poss, amps, (r, np.exp(-0.5*(r/(2*utils.arcmin))**2))


def c5_transform(lmax, device):
	from pixell_tpu_torch import uharm, wavelets
	shape, wcs = c5_geometry(lmax)
	uht = uharm.UHT(shape, wcs, mode="curved", lmax=lmax, device=device)
	return wavelets.WaveletTransform(uht, basis=wavelets.ButterTrim(step=2))


def c5_step(wt, cat, dtype, device, marks=None):
	"""sim_objects -> map2wave -> wave2map: (wave, rec); with marks (a list),
	a recorded CUDA event at each stage boundary."""
	from pixell_tpu_torch import pointsrcs
	poss, amps, prof = cat
	def mark():
		if marks is None: return
		e = torch.cuda.Event(enable_timing=True)
		e.record()
		marks.append(e)
	mark()
	omap = pointsrcs.sim_objects(wt.shape, wt.wcs, poss, amps, prof, dtype=dtype, device=device)
	mark()
	wave = wt.map2wave(omap)
	mark()
	del omap   # freed before the reconstruction, as the reference's loop does
	rec = wt.wave2map(wave)
	mark()
	return wave, rec


def c5_drive(label, fn, dtype, sym=True, full=True):
	"""fn driven with the counts at 0 just before and read just after, into
	C5_LAUNCHES; in dtype, K1 and K2 (sym) and K3 and K4 (full), and in
	float32 the near-pole passes, must have launched."""
	kinds = ["sym"]*sym + ["full"]*full
	synth, anal = [k + "_synthesis" for k in kinds], [k + "_analysis" for k in kinds]
	return hp_drive(label, fn, hp_entries(dtype, synth, anal), C5_LAUNCHES, "config5")


def c5_glue(wt, dtype):
	"""K2 / K4's partial planes in one step: every analysis of the step (the
	map's in map2wave, each scale's in wave2map) zero-fills [nplanes, nl, nm,
	2] a chunk launch and sums it with torch (ops/sht_cuda.py
	_analysis_launch); replayed here at the same shapes with CUDA events.
	(ms, bytes moved, the largest plane set in bytes)."""
	from pixell_tpu_torch import sht, curvedsky
	from pixell_tpu_torch.ops import sht_cuda
	esize = torch.finfo(dtype).bits//8
	shapes = {}
	for u in [wt.uht] + wt.uhts:
		lmax = u.lmax
		theta = sht.ring_theta("fejer1", curvedsky._upsampled_rings(None, lmax, u.shape[0]))
		if dtype == torch.float32:   # the near-pole rings go to the float64 pass
			nn, ns, _, _ = sht_cuda._polar_split(theta, lmax, lmax)
			if nn + ns < len(theta) and (nn or ns): theta = theta[nn:len(theta)-ns]
		nh = sht_cuda.detect_sym(theta)
		rings = nh if nh is not None else len(theta)
		for i0 in range(0, rings, sht_cuda.TCHUNK):
			n = min(sht_cuda.TCHUNK, rings - i0)
			key = (sht_cuda._planes(-(-n//sht_cuda.TILE_T)), lmax + 1, lmax + 1)
			shapes[key] = shapes.get(key, 0) + 1
	ms = nbytes = 0
	for (P, nl, nm), count in shapes.items():
		ms += count*cuda_ms(lambda: torch.zeros((P, nl, nm, 2), dtype=dtype, device=DEV).sum(0), 2)
		nbytes += count*(2*P + 1)*nl*nm*2*esize
	return ms, nbytes, max(P*nl*nm*2*esize for P, nl, nm in shapes)


def c5_guard_cpu():
	"""The whole chain in float64 on the card against CPU tensors, at
	C5_GUARD's lmax and sources on the smallest F1 grid: the source map,
	every scale and the reconstruction within C5_CPU_TOL."""
	lmax, nsrc = C5_GUARD
	cat = c5_catalogue(nsrc)
	outs = {}
	for dev in (DEV, "cpu"):
		wt = c5_transform(lmax, dev)
		from pixell_tpu_torch import pointsrcs
		m = pointsrcs.sim_objects(wt.shape, wt.wcs, *cat, dtype=torch.float64, device=dev)
		chain = lambda: (lambda w: (w, wt.wave2map(w)))(wt.map2wave(m))
		# the guard's small ring sets are all symmetric: K1 and K2 alone
		wave, rec = chain() if dev == "cpu" else c5_drive("lmax-%d guard" % lmax, chain, torch.float64,
			full=False)
		outs[dev] = [m.data.cpu()] + [w.data.cpu() for w in wave.maps] + [rec.data.cpu()]
	errs = [relerr(a, b) for a, b in zip(outs[DEV], outs["cpu"])]
	print("config5 guard (lmax %d, %d sources, %s map, %d scales): card against CPU float64 rel err: source map "
		"%.3e, scales max %.3e, reconstruction %.3e (bound %.0e)" % (lmax, nsrc, tuple(outs["cpu"][0].shape),
		len(errs) - 2, errs[0], max(errs[1:-1]), errs[-1], C5_CPU_TOL))
	return [] if max(errs) <= C5_CPU_TOL else ["config5 card against CPU %g" % max(errs)]


C5_SPARSE_TOL = {torch.float64: 1e-9, torch.float32: C5_F32_TOL}   # of the largest value
C5_SPARSE_ROWS = 256       # rings of the config-5 map held against the direct sum


def c5_sparse_pairs(lmax):
	"""(l, m) pairs across the whole triangle: m from 0 to lmax (powers of
	two and their neighbours, the last m rows), each at l = m, m + 1, the
	middle of its column and lmax, so that K3 and K4 reach the largest l, m
	and plane offsets."""
	ms = sorted({m for m in (0, 1, 2, 3, 17, 255, 256, 1023, 2048, 3001, 4095, 6000, 8191, lmax - 2, lmax - 1,
		lmax) if 0 <= m <= lmax})
	return sorted({(l, m) for m in ms for l in (m, m + 1, (m + lmax)//2, lmax) if l <= lmax})


def c5_lambda(theta, pairs, lmax):
	"""lambda_lm(theta) (the orthonormal associated Legendre functions with
	the Condon-Shortley phase) for the (l, m) in pairs: {(l, m): [ntheta]}
	numpy float64, by the textbook three-term recurrence in l up from
	lambda_mm, every m of pairs at once, each value kept as mantissa and
	log scale so that lambda_mm = O(sin^m theta) does not underflow. It
	shares no code with the kernels or the plain versions."""
	ms = np.array(sorted({m for _, m in pairs}), dtype=float)[:, None]
	want = {}
	for l, m in pairs: want.setdefault(l, []).append(m)
	x, ls = np.cos(theta)[None, :], np.log(np.sin(theta))[None, :]
	# log lambda_mm = log sqrt((2m+1)/4pi prod_k=1^m (2k-1)/(2k)) + m log sin theta
	lk = np.concatenate([[0.0], np.cumsum(np.log1p(-0.5/np.arange(1, lmax + 1)))])
	scale = 0.5*np.log((2*ms + 1)/(4*np.pi)) + 0.5*lk[ms.astype(int)] + ms*ls
	sign = np.where(ms % 2 == 1, -1.0, 1.0)
	prev, cur = np.zeros_like(scale), np.ones_like(scale)
	out = {}
	mi = {int(m): i for i, m in enumerate(ms[:, 0])}
	big = 1e150
	for l in range(int(ms[0, 0]), lmax + 1):
		# cur holds lambda_lm for the rows with m <= l; start each row at l = m
		start = ms[:, 0] == l
		if start.any(): prev[start], cur[start] = 0.0, 1.0
		for m in want.get(l, ()):
			i = mi[m]
			with np.errstate(divide="ignore"):
				out[(l, m)] = sign[i]*np.sign(cur[i])*np.exp(scale[i] + np.log(np.abs(cur[i])))
		lf = float(l + 1)
		live = ms <= l
		a = np.sqrt((4*lf*lf - 1)/np.maximum(lf*lf - ms*ms, 1))
		b = np.sqrt(np.maximum(l*l - ms*ms, 0)/(4.0*l*l - 1)) if l > 0 else np.zeros_like(ms)
		nxt = np.where(live, a*(x*cur - b*prev), cur)
		prev, cur = np.where(live, cur, prev), nxt
		hi = np.abs(cur) > big
		if hi.any():
			cur, prev, scale = np.where(hi, cur/big, cur), np.where(hi, prev/big, prev), scale + hi*np.log(big)
	return out


def c5_sparse(shape, wcs, lmax, rows, pairs, seed=7):
	"""(alm {(l, m): complex}, rows of the map they synthesise [len(rows),
	nx] numpy float64): the direct sum sum_lm a_lm lambda_lm(theta)
	e^(i m phi), real part, m > 0 twice, on the given rows of the full-sky
	F1 grid (shape, wcs)."""
	from pixell_tpu_torch import curvedsky, enmap
	rng = np.random.default_rng(seed)
	a = {p: complex(rng.uniform(0.5, 2.0), 0 if p[1] == 0 else rng.uniform(-2.0, 2.0)) for p in pairs}
	ny, nx = shape[-2:]
	# the F1 rings by their formula (rows from the south pole); the columns'
	# phases from the first column's phi0 that the transform takes from the
	# wcs (pix2sky rounds the wcs to ~1e-12 rad, which m = 10000 would see)
	dec0 = float(np.asarray(enmap.pix2sky(shape, wcs, np.array([0.0, 0.0])))[0])
	if abs(dec0 + np.pi/2 - np.pi/(2*ny)) > 1e-9: raise ValueError("not a full-sky F1 grid")
	theta = np.pi - np.pi*(np.asarray(rows) + 0.5)/ny
	minfo = curvedsky.analyse_geometry(shape, wcs)
	k = np.arange(nx)[::-1] if minfo.flip[1] else np.arange(nx)
	ra = minfo.phi0 + 2*np.pi*k/minfo.nphi
	lam = c5_lambda(theta, pairs, lmax)
	out = np.zeros((len(rows), nx))
	for m in sorted({m for _, m in pairs}):
		F = sum(a[(l, mm)]*lam[(l, mm)] for l, mm in pairs if mm == m)
		out += (1 if m == 0 else 2)*(F[:, None]*np.exp(1j*m*ra)[None, :]).real
	return a, out


def c5_sparse_rows(ny):
	"""C5_SPARSE_ROWS rings of ny: both polar caps, a dense band at the
	equator, the rest spread evenly."""
	band = np.arange(ny//2 - 48, ny//2 + 48)
	caps = np.r_[np.arange(8), np.arange(ny - 8, ny)]
	rest = np.linspace(0, ny - 1, C5_SPARSE_ROWS - len(band) - len(caps)).astype(int)
	rows = np.unique(np.r_[caps, band, rest])
	return rows[:C5_SPARSE_ROWS]


def c5_sparse_check(shape, wcs, lmax, dtype, device, ref):
	"""K3 and K4 at config 5's size against an independent reference: the
	sparse alm of ref (c5_sparse) synthesised by alm2map onto the map's
	rings, held on ref's rows against the direct sum, then analysed back by
	map2alm, every (l, m) of the triangle held against the sparse alm;
	both within C5_SPARSE_TOL of the largest value. Returns (synthesis err,
	analysis err)."""
	from pixell_tpu_torch import curvedsky, enmap, sht
	(a, rows, direct) = ref
	cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
	alm = torch.zeros(sht.nalm(lmax), dtype=cdt, device=device)
	idx = torch.tensor([sht.lm2ind(lmax, l, m) for l, m in a], device=device)
	alm[idx] = torch.tensor(list(a.values()), dtype=cdt, device=device)
	m = curvedsky.alm2map(alm, enmap.zeros(shape, wcs, dtype, device=device), spin=0)
	syn = relerr(torch.from_numpy(direct), m.data[torch.as_tensor(rows, device=device)].cpu())
	back = curvedsky.map2alm(m, lmax=lmax, spin=0)
	del m
	ana = relerr(back, alm)
	return syn, ana


def c5_timed(wt, cat, dtype, nrep):
	"""(step, [srcsim, map2wave, wave2map]) ms of nrep steps (the tables
	built and cached by an earlier step), CUDA events; each step's outputs
	freed before the next."""
	wave = rec = None
	steps, stages = [], []
	for it in range(nrep):
		wave = rec = None
		marks = []
		wave, rec = c5_step(wt, cat, dtype, DEV, marks)
		torch.cuda.synchronize()
		st = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
		stages.append(st)
		steps.append(marks[0].elapsed_time(marks[-1]))
	del wave, rec
	return steps, stages


def c5_paint(wt, cat, dtype, step_ms):
	"""sim_objects alone (median of 3) against its bytes bound: the map
	written once, the cell tables and sources read once."""
	from pixell_tpu_torch import pointsrcs
	poss, amps, prof = cat
	fn = lambda: pointsrcs.sim_objects(wt.shape, wt.wcs, poss, amps, prof, dtype=dtype, device=DEV)
	med, lo, hi = flat_time(fn, 1, 3)
	esize = torch.finfo(dtype).bits//8
	npix = int(np.prod(wt.shape))
	nbytes = npix*esize + C5_NSRC*(3*esize + 8) + 2*1000*esize
	b = 1e3*nbytes/PEAK_BYTES
	print("config5 %s: sim_objects (%d sources; cells of %d px, host assignment, plain-torch paint) %.3f ms "
		"(median of 3; min %.3f, max %.3f); bytes bound %.3f ms (%.2f %% of it; %.3f GB); %.2f %% of the step"
		% (str(dtype)[6:], C5_NSRC, pointsrcs.CSIZE, med, lo, hi, b, 100*b/med, nbytes/1e9, 100*med/step_ms))
	return med


def c5_cache_bytes():
	"""(device bytes the SHT's table caches hold, their own count of the bytes
	they hold): allocated before and after clearing them (they are rebuilt
	on the next call)."""
	from pixell_tpu_torch.ops import tablecache
	torch.cuda.synchronize()
	before, counted = torch.cuda.memory_allocated(), tablecache.held()
	tablecache.clear()
	torch.cuda.synchronize()
	return before - torch.cuda.memory_allocated(), counted


def config5_phase():
	"""Guards at lmax 64 first, then BASELINE config 5 at full size: f32
	(median of 3) with stages, launches, peak, busy share, painting and
	glue; one f64 step; the f64 identity and f32 against f64."""
	from pixell_tpu_torch import curvedsky
	h0 = time.perf_counter()
	C5_LAUNCHES.clear()
	failed = c5_guard_cpu()
	c5_cache_bytes()   # start from empty table caches: the earlier phases' tables are not config 5's
	torch.cuda.empty_cache()
	t0 = time.perf_counter()
	wt = c5_transform(C5_LMAX, DEV)
	cat = c5_catalogue(C5_NSRC)
	print("config5: map %s, lmax %d, %d scales (ButterTrim(step=2)), %.3f G wavelet pixels; transform built in "
		"%.2f s (host)" % (tuple(wt.shape), C5_LMAX, wt.nlevel, sum(int(np.prod(g[0])) for g in wt.geometries)/1e9,
		time.perf_counter() - t0))
	for i, (g, u) in enumerate(zip(wt.geometries, wt.uhts)):
		print("config5 scale %d: %s lmax %d, support %s" % (i, tuple(g[0]), u.lmax, wt.basis.lbounds(i)))
	t0 = time.perf_counter()
	rows = c5_sparse_rows(wt.shape[0])
	sparse = c5_sparse(wt.shape, wt.wcs, C5_LMAX, rows, c5_sparse_pairs(C5_LMAX))
	sparse = (sparse[0], rows, sparse[1])
	print("config5: sparse-alm direct sum on %d rings in %.1f s (host)" % (len(rows), time.perf_counter() - t0))
	recs = {}
	for dtype in (torch.float32, torch.float64):
		tag = str(dtype)[6:]
		t0 = time.perf_counter()
		c5_step(wt, cat, dtype, DEV)   # warm-up: builds and caches every table of the step
		torch.cuda.synchronize()
		print("config5 %s: first step (tables built on the host) %.1f s" % (tag, time.perf_counter() - t0))
		torch.cuda.empty_cache()
		torch.cuda.reset_peak_memory_stats()
		marks = []
		wave, rec = c5_drive("config 5 step %s" % tag, lambda: c5_step(wt, cat, dtype, DEV, marks), dtype)
		torch.cuda.synchronize()
		peak = torch.cuda.max_memory_allocated()/2**30
		# the driven step is the first timed one
		steps = [marks[0].elapsed_time(marks[-1])]
		stages = [[a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]]
		ok = tuple(rec.shape) == tuple(wt.shape) and rec.dtype == dtype and bool(torch.isfinite(rec.data).all()) \
			and len(wave.maps) == wt.nlevel
		print("config5 %s: output %s %s, %d wavelet maps; peak device memory %.2f GiB (bound %d)" % (tag,
			tuple(rec.shape), rec.dtype, len(wave.maps), peak, FLAT_MEM_GIB))
		if not ok: raise RuntimeError("config5 %s: output not finite or of the wrong shape" % tag)
		if not peak < FLAT_MEM_GIB: raise RuntimeError("config5 %s: peak %.2f GiB" % (tag, peak))
		recs[dtype] = rec.data
		del wave, rec
		torch.cuda.empty_cache()
		more, more_stages = c5_timed(wt, cat, dtype, 1 if dtype == torch.float32 else 0)
		steps, stages = steps + more, stages + more_stages
		med = float(np.median(steps))
		print("config5 %s: %.3f ms a step (median of %d; min %.3f, max %.3f)" % (tag, med, len(steps), min(steps),
			max(steps)))
		for j, name in enumerate(("srcsim", "map2wave", "wave2map")):
			v = [s[j] for s in stages]
			print("config5 %s: stage %s %.3f ms (median of %d; min %.3f, max %.3f), %.1f %% of the step" % (tag,
				name, float(np.median(v)), len(v), min(v), max(v), 100*float(np.median(v))/med))
		syn, ana = c5_drive("lmax-%d sparse alm %s" % (C5_LMAX, tag), lambda: c5_sparse_check(wt.shape, wt.wcs,
			C5_LMAX, dtype, DEV, sparse), dtype, sym=False)
		print("config5 %s: sparse alm (%d (l, m) pairs, up to l = m = %d): alm2map (K3) on %d of the %d rings "
			"against the numpy direct sum, rel err %.3e; map2alm (K4) back against the sparse alm, rel err %.3e "
			"(bound %.0e)" % (tag, len(sparse[0]), C5_LMAX, len(sparse[1]), wt.shape[0], syn, ana,
			C5_SPARSE_TOL[dtype]))
		if not max(syn, ana) <= C5_SPARSE_TOL[dtype]:
			failed.append("config5 %s sparse alm: synthesis %g, analysis %g" % (tag, syn, ana))
		torch.cuda.empty_cache()
		if dtype == torch.float32:
			c5_paint(wt, cat, dtype, med)
			gms, gbytes, gbig = c5_glue(wt, dtype)
			print("config5 %s: K2 / K4 partial planes (zero-fill and torch sum, replayed at the step's shapes) "
				"%.3f ms a step, %.1f %% of it; %.2f GB moved, bytes bound %.3f ms; largest plane set %.2f GiB"
				% (tag, gms, 100*gms/med, gbytes/1e9, 1e3*gbytes/PEAK_BYTES, gbig/2**30))
			wall, busy = flat_profile(lambda: c5_step(wt, cat, dtype, DEV), 20, "config5 %s step" % tag)
			print("config5 %s: device busy %.1f %% of one profiled step" % (tag, 100*busy/wall))
		torch.cuda.empty_cache()
	from pixell_tpu_torch.ops import tablecache
	res, counted = c5_cache_bytes()
	print("config5: SHT table caches resident after both dtypes %.2f GiB (their own count %.2f GiB, budget "
		"%.2f GiB)" % (res/2**30, counted/2**30, tablecache.budget()/2**30))
	torch.cuda.empty_cache()
	# guard 1: the f64 identity, wave2map(map2wave(m)) = harm2map(sum_i k_i^2 map2harm(m))
	from pixell_tpu_torch import pointsrcs
	m = pointsrcs.sim_objects(wt.shape, wt.wcs, *cat, dtype=torch.float64, device=DEV)
	alm = wt.uht.map2harm(m)
	l = np.arange(C5_LMAX + 1, dtype=float)
	k2 = sum(np.where(l <= u.lmax, wt.basis.kernel(i, l), 0)**2 for i, u in enumerate(wt.uhts))
	ref = wt.uht.harm2map(curvedsky.almxfl(alm, k2, ainfo=wt.uht.ainfo)).data
	del alm, m
	err = relerr(recs[torch.float64], ref)
	print("config5 float64: wave2map(map2wave(m)) against harm2map(sum_i k_i^2 map2harm(m)) at lmax %d rel err "
		"%.3e (bound %.0e); sum_i k_i^2 in [%.6f, %.6f]" % (C5_LMAX, err, C5_ID_TOL, k2.min(), k2.max()))
	if not err <= C5_ID_TOL: failed.append("config5 f64 identity %g" % err)
	del ref
	err = relerr(recs[torch.float32], recs[torch.float64])
	print("config5: float32 reconstruction against float64 at lmax %d rel err %.3e (bound %.0e)" % (C5_LMAX, err,
		C5_F32_TOL))
	if not err <= C5_F32_TOL: failed.append("config5 f32 against f64 %g" % err)
	del recs, wt
	c5_cache_bytes()
	torch.cuda.empty_cache()
	print("config5 launches in all its paths (each driven with the counts at 0): %s" % C5_LAUNCHES)
	print("config5 phase: %.1f s" % (time.perf_counter() - h0))
	if failed: raise RuntimeError("config5 guards failed:\n" + "\n".join(failed))


# ---------------------------------------------------------------------------
# 13. analysis: distance transforms, masks and the matched-filter finder on
# the DR6-sized band (K13 jump_flood, K14 nearest_point; csrc/distances.cu)
# ---------------------------------------------------------------------------
DIST_SOURCE = "pixell_tpu_torch/csrc/distances.cu"
AN_NSRC = 10_000               # injected sources
AN_NBRIGHT = 1000              # the brightest, masked out to AN_BRIGHT_R and inpainted
AN_FWHM = 1.4                  # arcmin, Gaussian beam
AN_SN = (3.0, 300.0)           # log-uniform S/N of the sources
AN_BRIGHT_R = 5.0              # arcmin
AN_APOD = 1.0                  # degrees
AN_SNMIN = 5                   # the finder's threshold
AN_CUT = (1024, 2048)          # the twins' cut of the band (from its row ny // 3 and column nx // 2)
AN_REC_ROWS = 256              # full-width rows of the records' timing cut
AN_HP = (256, 2048)            # nside of the twins' guard, of the one-shot HEALPix runs
AN_EXACT_TOL = 1e-12           # K13 against K14's exact distance, radians
AN_EXACT_SHARE = 0.999         # share of pixels K13 must get within AN_EXACT_TOL
AN_CPU_TOL = 1e-12             # the chain on the card against CPU tensors, float64, of the largest value
AN_CPU_SHAPE = (64, 128)       # the chain's guard cut (from the band's row ny // 2 and column nx // 2)
AN_FIND = (10.0, 2.0)          # S/N and pixels of the finder's guard
# sim_srcs_dist_transform against sim_objects, of the largest value: where it paints (sim_objects interpolates
# an equispaced resampling of the profile, pointsrcs._equi_profiles, the distance transform the profile
# itself: 3.5e-6 on the card), and sim_objects' paint beyond its disks (its rim, ~exp(-8) of a peak)
AN_DT_TOL = (1e-5, 1e-3)
AN_NREP = 2                    # timed steps after the profiled one (3 until the utils phase took their time)
# FP64 operations the two functions need (an FMA 2), counted from the work and not from the kernels' Vincenty
# form, with unit vectors made once a pixel and once a point or seed. An evaluated candidate of K13 needs a dot
# product and a compare: 1 multiply and 2 FMA (5) and 1. A pixel-point pair of K14 needs the sign of its dot
# product less the pixel's threshold: 3 FMA (6, the threshold folded into the chain, the sign an integer test);
# on a separable geometry the column's cos ra x + sin ra y is shared by every row (a multiply and an FMA, 3, a
# column and point), which leaves 2 FMA (4) a pair (forming cos dec a + sin dec z, whose second term a row
# shares, with 1 FMA and comparing it in FP64 takes as many FP64 instructions). K14 then needs one angle a
# pixel, counted as the 10 explicit operations of csrc/distances.cu's vincenty. The unit vectors' and the
# angle's sincos, hypot and atan2 are not counted, so each bound is a lower bound.
AN_EVAL_OPS = 6
AN_PAIR_OPS = {True: 4, False: 6}    # K14, by separable geometry
AN_COLUMN_OPS = 3
AN_ANGLE_OPS = 10
AN_PAIR_OPS_OLD = 6                  # the earlier count for K14 (a multiply, 2 FMA and an FP64 compare): not the bound
AN_LAUNCHES = {}               # launches of the analysis paths, by kernel


def an_geometry():
	from pixell_tpu_torch import enmap, utils
	return enmap.band_geometry(np.array([-63, 23])*utils.degree, res=0.5*utils.arcmin)


def an_profile():
	"""The unit-integral Gaussian beam (r, b(r)) of AN_FWHM on 1000 radii."""
	from pixell_tpu_torch import utils
	sigma = AN_FWHM*utils.arcmin*utils.fwhm
	r = np.linspace(0, 10*sigma, 1000)
	return np.array([r, np.exp(-0.5*(r/sigma)**2)/(2*np.pi*sigma**2)])


def an_drive(label, fn):
	"""fn() with the distance kernels' counts at 0 just before and read just
	after, added into AN_LAUNCHES; both kernels must have launched unless
	the label says which."""
	from pixell_tpu_torch.ops import distances_cuda
	distances_cuda.reset_launches()
	res = fn()
	torch.cuda.synchronize()
	got = dict(distances_cuda.LAUNCHES)
	for k, v in got.items(): AN_LAUNCHES[k] = AN_LAUNCHES.get(k, 0) + v
	print("analysis %s: launches %s" % (label, got))
	return res, got


@contextlib.contextmanager
def an_plain(evals=None):
	"""Inside, distances_cuda's wrappers take their CPU branch on every
	device: the same calls run the plain versions on the card, and no
	launch is counted. With evals (a list), each flood pass appends its
	count of pixels whose candidate is evaluated (a seed, not the pixel's
	own)."""
	from pixell_tpu_torch.ops import distances_cuda, distances_core as core
	on_card, plain = distances_cuda._on_card, dict(distances_cuda.PLAIN)

	def counted(seed, pd, pr, table, sy, sx, wrapx):
		c = core.shift2d(seed, sy, sx, wrapx, -1)
		evals.append(int(((c >= 0) & (c != seed)).sum()))
		return plain["jump_flood"](seed, pd, pr, table, sy, sx, wrapx)
	distances_cuda._on_card = lambda x: False
	if evals is not None: distances_cuda.PLAIN["jump_flood"] = counted
	try:
		yield
	finally:
		distances_cuda._on_card = on_card
		distances_cuda.PLAIN.update(plain)


def an_nearest_plain(pd, pr, pt, shape, rows=128):
	"""K14's wrapper through its plain version on the card, rows rows at a
	time (the plain version's [pixels, 128] blocks would not fit at once)."""
	from pixell_tpu_torch.ops import distances_cuda
	pd, pr = pd.expand(shape), pr.expand(shape)
	with an_plain():
		out = [distances_cuda.nearest_point(pd[i:i+rows], pr[i:i+rows], pt[0], pt[1], (min(rows, shape[0]-i),
			shape[1])) for i in range(0, shape[0], rows)]
	return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def an_twin_check(label, dk, dp, sk, sp, failed):
	"""The kernel's distances and seeds or domains (dk, sk) equal to the
	plain version's (dp, sp) bit for bit."""
	err = float((dk - dp).abs().max()) if dk.numel() else 0.0
	ndiff = int((sk != sp).sum())
	same = torch.equal(dk, dp) and torch.equal(sk, sp)
	print("analysis twin %s: %s; max |d - d_plain| %.3e rad, %d seeds differ" % (label,
		"bit-identical" if same else "DIFFERENT", err, ndiff))
	if not same: failed.append("twin %s: %g, %d seeds" % (label, err, ndiff))
	return err


def an_points_on(shape, wcs, n, rng, margin=0):
	"""n points [{dec, ra}, n] at distinct random pixels of the geometry,
	displaced by up to 0.3 pixels (no two round to one pixel), and those
	pixels' flat indices."""
	from pixell_tpu_torch import enmap
	ny, nx = shape[-2:]
	flat = rng.choice((ny - 2*margin)*(nx - 2*margin), n, replace=False)
	pix = np.array([flat//(nx - 2*margin) + margin, flat % (nx - 2*margin) + margin], float)
	pix += rng.uniform(-0.3, 0.3, pix.shape)
	return enmap.pix2sky(shape, wcs, pix), np.round(pix).astype(int)


def an_tie_points(cdec, cra, step, a):
	"""The near-tie set: for each centre (cdec, cra), four points mirrored
	about it, step away in RA and in dec; for each point of a [{dec, ra}, m]
	that point and two more 1e-15 rad from it (in dec, in RA).
	[{dec, ra}, 4 n + 3 m]."""
	out = [np.array([cdec, cra + step]), np.array([cdec, cra - step]), np.array([cdec + step, cra]),
		np.array([cdec - step, cra]), a, a + np.array([[1e-15], [0]]), a + np.array([[0], [1e-15]])]
	return np.concatenate(out, 1)


def an_distinct(idx, n):
	"""idx (ints in [0, n)) made distinct: a repeat moves on to the next free
	index, modulo n."""
	seen, out = set(), []
	for i in np.asarray(idx).tolist():
		while i in seen: i = (i + 1) % n
		seen.add(i)
		out.append(i)
	return np.array(out)


def an_near_ties(failed, cshape, cwcs, pd, pr, steps, wrapx, rng):
	"""K13 and K14 against their plain versions, bit for bit, on the
	near-tie set (an_tie_points): on the cut, 200 pixel centres with points
	1-3 pixels to either side and 50 triples 1e-15 rad apart (K14; K13 from
	the same points as a seed table, each seeded at its pixel or the next
	free one); at nside AN_HP[0] about 200 pixel centres, a ring's pixel to
	either side in RA and a ring spacing in dec, and 50 triples (brute, K14;
	grid, K13, each point seeded at a distinct pixel)."""
	from pixell_tpu_torch import enmap, distances, healpix
	from pixell_tpu_torch.ops import distances_cuda
	dec, ra = pd[:, 0].cpu().numpy(), pr[0].cpu().numpy()
	ny, nx = cshape
	cy, cx = rng.integers(4, ny - 4, 200), rng.integers(4, nx - 4, 200)
	a = np.array([rng.uniform(dec.min(), dec.max(), 50), rng.uniform(ra.min(), ra.max(), 50)])
	tp = an_tie_points(dec[cy], ra[cx], rng.integers(1, 4, 200)*abs(ra[1] - ra[0]), a)
	pt = torch.from_numpy(tp).to(DEV)
	ek, ik = distances_cuda.nearest_point(pd, pr, pt[0], pt[1], cshape)
	ep, ip = an_nearest_plain(pd, pr, pt, cshape)
	an_twin_check("K14 %s near-tie set, %d points" % (cshape, tp.shape[1]), ek, ep, ik, ip, failed)
	pix = np.round(np.asarray(enmap.sky2pix(cshape, cwcs, tp))).astype(int)
	flat = an_distinct(np.clip(pix[0], 0, ny - 1)*nx + np.clip(pix[1], 0, nx - 1), ny*nx)
	seed = torch.full((ny*nx,), -1, dtype=torch.int32, device=DEV)
	seed[torch.from_numpy(flat).to(DEV)] = torch.arange(tp.shape[1], dtype=torch.int32, device=DEV)
	seed = seed.reshape(cshape)
	sk, dk = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps, (pt[0], pt[1]))
	with an_plain():
		sp, dp = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps, (pt[0], pt[1]))
	an_twin_check("K13 %s near-tie set as seeds" % (cshape,), dk, dp, sk, sp, failed)
	nside = AN_HP[0]
	info = distances.healpix_info(nside)
	c = rng.choice(info.npix, 200, replace=False)
	y, x = distances.unravel_healpix(info, c)
	a = np.array([np.arcsin(rng.uniform(-1, 1, 50)), rng.uniform(0, 2*np.pi, 50)])
	hc = an_tie_points(info.dec[y], info.ra0[y] + x*(2*np.pi)/info.nx[y], np.pi/(4*nside), a)
	hc[1, :400] = np.concatenate([info.ra0[y] + (x + 1)*(2*np.pi)/info.nx[y], info.ra0[y] + (x - 1)*(2*np.pi)/
		info.nx[y]])   # the RA mirrors: the neighbouring pixel centres of the ring
	hc[0] = np.clip(hc[0], -np.pi/2, np.pi/2)
	pp = an_distinct(np.asarray(healpix.ang2pix(nside, np.pi/2 - hc[0], hc[1])), info.npix)
	for method in ("brute", "grid"):
		run = lambda: distances.distance_from_points_healpix(info, hc, point_pix=pp, domains=True, method=method,
			device=DEV)
		dkh, lkh = run()
		with an_plain():
			dph, lph = run()
		an_twin_check("nside %d %s, near-tie set of %d points" % (nside, method, hc.shape[1]), dkh, dph, lkh,
			lph, failed)


def an_twins(failed):
	"""K13 and K14 against their plain versions on the card, bit for bit: on
	a 1024 x 2048 cut of the band (pixel seeds, point seeds, 1000 points)
	and at nside 256 (brute, grid), and on the near-tie set (an_near_ties);
	then K13 against K14's exact distance on the cut."""
	from pixell_tpu_torch import enmap, distances
	from pixell_tpu_torch.ops import distances_cuda
	shape, wcs = an_geometry()
	y0, x0 = shape[-2]//3, shape[-1]//2
	cshape, cwcs = enmap.slice_geometry(shape, wcs, (slice(y0, y0 + AN_CUT[0]), slice(x0, x0 + AN_CUT[1])))
	rng = np.random.default_rng(31)
	pd, pr = distances._positions(cshape, cwcs, DEV)
	steps, wrapx = distances._steps_for(max(cshape)), distances._is_wrapx(cshape, cwcs)
	n = int(np.prod(cshape))
	errs = {}
	# pixel seeds (the transforms)
	seed = torch.where(torch.from_numpy(rng.uniform(size=cshape) < 1e-3).to(DEV),
		torch.arange(n, device=DEV, dtype=torch.int32).reshape(cshape), -1)
	sk, dk = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps)
	with an_plain():
		sp, dp = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps)
	errs["jump_flood"] = an_twin_check("K13 %s pixel seeds" % (cshape,), dk, dp, sk, sp, failed)
	# the same flood with int64 seeds (jump_flood_kernel<long long>, for seed tables of 2^31 or more): equal
	# to the int32 kernel's and to the plain version's
	s64, d64 = distances_cuda.jump_flood(seed.to(torch.int64), pd, pr, wrapx, steps)
	same = s64.dtype == torch.int64 and bool((s64 == sk.to(torch.int64)).all()) and bool((d64 == dk).all())
	print("analysis twin K13 %s pixel seeds, int64: seeds and distances %s the int32 kernel's" % (cshape,
		"equal to" if same else "DIFFERENT FROM"))
	if not same: failed.append("K13 int64 seeds differ from int32")
	an_twin_check("K13 %s pixel seeds, int64" % (cshape,), d64, dp, s64, sp.to(torch.int64), failed)
	# point seeds (a table), 1000 points: K13, K14, and K13 against K14's exact distance
	pts, pix = an_points_on(cshape, cwcs, 1000, rng)
	pt = torch.from_numpy(pts).to(DEV)
	seed = torch.full(cshape, -1, dtype=torch.int32, device=DEV)
	seed[torch.from_numpy(pix[0]).to(DEV), torch.from_numpy(pix[1]).to(DEV)] = torch.arange(1000, dtype=torch.int32,
		device=DEV)
	sk, dk = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps, (pt[0], pt[1]))
	with an_plain():
		sp, dp = distances_cuda.jump_flood(seed, pd, pr, wrapx, steps, (pt[0], pt[1]))
	errs["jump_flood"] = max(errs["jump_flood"], an_twin_check("K13 %s 1000 point seeds" % (cshape,), dk, dp, sk,
		sp, failed))
	ek, ik = distances_cuda.nearest_point(pd, pr, pt[0], pt[1], cshape)
	ep, ip = an_nearest_plain(pd, pr, pt, cshape)
	errs["nearest_point"] = an_twin_check("K14 %s 1000 points" % (cshape,), ek, ep, ik, ip, failed)
	below = float((ek - dk).max())   # K13 shorter than the exact distance by
	share = float(((dk - ek).abs() <= AN_EXACT_TOL).double().mean())
	print("analysis K13 against K14's exact distance on %s, 1000 points: K13 shorter by at most %.3e rad (bound "
		"%.0e); %.5f %% of pixels within %.0e (bound %.1f %%): the flood's rate of misses %.5f %%" % (cshape, below,
		AN_EXACT_TOL, 100*share, AN_EXACT_TOL, 100*AN_EXACT_SHARE, 100*(1 - share)))
	if not (below <= AN_EXACT_TOL and share >= AN_EXACT_SHARE):
		failed.append("K13 against exact: shorter by %g, share %g" % (below, share))
	# HEALPix at nside 256: brute (K14) and grid (K13) against their plain versions
	nside = AN_HP[0]
	info = distances.healpix_info(nside)
	hp = np.array([np.arcsin(rng.uniform(-1, 1, 500)), rng.uniform(0, 2*np.pi, 500)])
	for method in ("brute", "grid"):
		dkh, lkh = distances.distance_from_points_healpix(info, hp, domains=True, method=method, device=DEV)
		with an_plain():
			dph, lph = distances.distance_from_points_healpix(info, hp, domains=True, method=method, device=DEV)
		e = an_twin_check("nside %d %s, 500 points" % (nside, method), dkh, dph, lkh, lph, failed)
		key = "nearest_point" if method == "brute" else "jump_flood"
		errs[key] = max(errs[key], e)
	an_near_ties(failed, cshape, cwcs, pd, pr, steps, wrapx, rng)
	return errs


def an_finder(shape, wcs, ivar, prof, device):
	"""The step's finder, FinderMultiSafe over one NmatConstcorr (iC = 1,
	the beam prof, a flat UHT), and that noise model."""
	from pixell_tpu_torch import analysis, uharm, enmap
	uht = uharm.UHT(shape, wcs, mode="flat", device=device)
	B = uht.rprof2hprof(prof[1], prof[0])
	iC = enmap.ndmap(torch.ones(B.shape, dtype=torch.float64, device=device), wcs)
	nmat = analysis.NmatConstcorr(iC, ivar, B, uht)
	return analysis.FinderMultiSafe([nmat], snmin=AN_SNMIN), nmat


def an_step(shape, wcs, cat, noise, prof, finder, device, dtype, bright_r, apod_w, marks=None):
	"""One step: the sources painted plus noise (srcsim); the bright-source
	mask, distance_from(<brightest>) > bright_r (mask, K14); apod_mask of
	the footprint over apod_w (apod, K13); the finder on the apodized map
	(find: matched filter, host labelling, K13 circles); inpaint of the map
	where the mask is False (inpaint, K13 with indices). (keep, apod,
	finder's result, inpainted map)."""
	from pixell_tpu_torch import enmap, pointsrcs
	poss, flux, bright = cat
	def mark():
		if marks is None: return
		e = torch.cuda.Event(enable_timing=True)
		e.record()
		marks.append(e)
	mark()
	m = pointsrcs.sim_objects(shape, wcs, poss, flux, prof, dtype=dtype, device=device)
	m = enmap.ndmap(m.data + noise, wcs)
	mark()
	keep = enmap.distance_from(shape, wcs, bright, device=device).data > bright_r
	mark()
	apod = enmap.apod_mask(enmap.ndmap(torch.ones(tuple(shape), dtype=torch.bool, device=device), wcs), apod_w)
	mark()
	res = finder(enmap.ndmap(m.data*apod.data, wcs))
	mark()
	filled = enmap.inpaint(m, ~keep)
	mark()
	return keep, apod, res, filled


def an_small_chain(device):
	"""The whole chain in float64 at AN_CPU_SHAPE (a cut of the band) with
	inputs from a numpy seed: 12 sources, 3 of them bright."""
	from pixell_tpu_torch import enmap, utils
	shape, wcs = an_geometry()
	y0, x0 = shape[-2]//2, shape[-1]//2
	cshape, cwcs = enmap.slice_geometry(shape, wcs, (slice(y0, y0 + AN_CPU_SHAPE[0]), slice(x0, x0 + AN_CPU_SHAPE[1])))
	rng = np.random.default_rng(41)
	poss, _ = an_points_on(cshape, cwcs, 12, rng, margin=8)
	flux = rng.uniform(1, 3, 12)*1e-6
	bright = poss[:, np.argsort(flux)[-3:]]
	ivar = enmap.ndmap(torch.from_numpy(rng.uniform(0.5, 1.5, cshape)*1e4).to(device), cwcs)
	noise = torch.from_numpy(rng.standard_normal(cshape)*1e-2).to(device)
	prof = an_profile()
	finder, _ = an_finder(cshape, cwcs, ivar, prof, device)
	return an_step(cshape, cwcs, (poss, flux, bright), noise, prof, finder, device, torch.float64,
		2*utils.arcmin, 5*utils.arcmin)


def an_cpu_guard(failed):
	"""The chain on the card against the same chain on CPU tensors."""
	(kc, ac, rc, fc), launches = an_drive("chain at %s on the card, float64" % (AN_CPU_SHAPE,),
		lambda: an_small_chain(DEV))
	kh, ah, rh, fh = an_small_chain("cpu")
	errs = {"mask": float((kc.cpu() != kh).sum()), "apod": relerr(ac.data.cpu(), ah.data),
		"snr": relerr(rc.snr.data.cpu(), rh.snr.data), "inpaint": relerr(fc.data.cpu(), fh.data)}
	same = len(rc.cat) == len(rh.cat) and len(rc.cat) > 0
	if same:
		for f in ("dec", "ra", "flux", "dflux", "snr"):
			errs["cat." + f] = float(np.max(np.abs(rc.cat[f] - rh.cat[f]))/np.max(np.abs(rh.cat[f])))
	print("analysis chain %s float64, card against CPU tensors: %d and %d objects found; errors %s (bound %.0e)" % (
		AN_CPU_SHAPE, len(rc.cat), len(rh.cat), {k: "%.3e" % v for k, v in errs.items()}, AN_CPU_TOL))
	if not same or not all(v <= AN_CPU_TOL for v in errs.values()) or not all(launches.values()):
		failed.append("chain card against CPU: %d / %d objects, %s, launches %s" % (len(rc.cat), len(rh.cat), errs,
			launches))


def an_catalogue(shape, wcs, kappa):
	"""AN_NSRC sources, one in each of as many random cells of 32 x 32
	pixels, within 8 pixels of its centre (so at least 16 pixels apart, and
	16 from the band's top and bottom), S/N log-uniform in AN_SN, their
	fluxes from the filter's kappa at their pixels: (poss, flux, S/N, bright
	poss, pixels)."""
	from pixell_tpu_torch import enmap
	rng = np.random.default_rng(22)
	ny, nx = shape[-2:]
	cy, cx = ny//32, nx//32
	cell = rng.choice(cy*cx, AN_NSRC, replace=False)
	pix = np.array([(cell//cx)*32 + 16, (cell % cx)*32 + 16]) + rng.integers(-8, 9, (2, AN_NSRC))
	sn = np.exp(rng.uniform(np.log(AN_SN[0]), np.log(AN_SN[1]), AN_NSRC))
	k = kappa[torch.from_numpy(pix[0]).to(kappa.device), torch.from_numpy(pix[1]).to(kappa.device)].cpu().numpy()
	flux = sn/np.sqrt(k)
	poss = enmap.pix2sky(shape, wcs, pix.astype(float))
	bright = poss[:, np.argsort(sn)[-AN_NBRIGHT:]]
	return poss, flux, sn, bright, pix


def an_profile_step(fn, label):
	"""(fn(), wall ms, busy ms, (K13 ms a launch, K14 ms a launch)) of fn
	under the profiler: device time by op; fails
	on a host <-> device copy above FLAT_COPY_BYTES whose call was issued
	outside the finder's named host stages (analysis.<stage>)."""
	from torch.profiler import profile, ProfilerActivity
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		h0 = time.perf_counter()
		out = fn()
		torch.cuda.synchronize()
		wall = (time.perf_counter() - h0)*1e3
	ka = prof.key_averages()
	key = _device_key(ka)
	busy = sum(getattr(e, key) for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
		and not getattr(e, "is_user_annotation", False))/1e3
	print(ka.table(sort_by=key, row_limit=14, max_name_column_width=56))
	band = []
	for pattern in ("jump_flood_kernel", "nearest_point_kernel"):
		ev = [e for e in ka if re.search(pattern, e.key)]
		count = sum(e.count for e in ev)
		band.append(sum(getattr(e, key) for e in ev)/1e3/count if count else None)
		print("analysis %s: %s %d launches, %.3f ms device time in all" % (label, pattern, count,
			sum(getattr(e, key) for e in ev)/1e3))
	path = os.path.join(ROOT, "build", "analysis_trace.json")
	os.makedirs(os.path.dirname(path), exist_ok=True)
	prof.export_chrome_trace(path)
	with open(path) as f: events = json.load(f)["traceEvents"]
	os.remove(path)
	stages = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
		if str(e.get("name", "")).startswith("analysis.") and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
	calls = {(e.get("args") or {}).get("correlation"): e["ts"] for e in events if e.get("cat") == "cuda_runtime"}
	copies = [e for e in events if e.get("cat") == "gpu_memcpy" and ("HtoD" in e.get("name", "")
		or "DtoH" in e.get("name", ""))]
	big, named = [], {}
	for e in copies:
		nb = (e.get("args") or {}).get("bytes")
		if not ((nb is not None and nb > FLAT_COPY_BYTES) or (nb is None and e.get("dur", 0) > 50)): continue
		t = calls.get((e.get("args") or {}).get("correlation"))
		inside = [s[2] for s in stages if t is not None and s[0] <= t <= s[1]]
		if inside: named[inside[0]] = named.get(inside[0], 0) + (nb or 0)
		else: big.append((e.get("name"), nb, e.get("dur")))
	print("analysis %s: one profiled step: wall %.3f ms, device busy %.3f ms (%.1f %%); %d host <-> device copies; "
		"above %d bytes inside the named host stages: %s" % (label, wall, busy, 100*busy/wall, len(copies),
		FLAT_COPY_BYTES, named))
	if big: raise RuntimeError("analysis %s: host <-> device copies above %d bytes outside the named host stages: "
		"%s" % (label, FLAT_COPY_BYTES, big[:5]))
	return out, wall, busy, band


def an_find_guard(res, cat, apod, failed):
	"""Every injected source of expected S/N >= AN_FIND[0] (its S/N times
	the apodization at its pixel: the finder runs on the apodized map) found
	within AN_FIND[1] pixels, and every found source of S/N >= AN_FIND[0]
	within AN_FIND[1] pixels of an injected one."""
	from pixell_tpu_torch import enmap
	import scipy.spatial
	shape, wcs = an_geometry()
	poss, flux, sn, bright, pix = cat
	sn_exp = sn*apod.data[torch.from_numpy(pix[0]).to(DEV), torch.from_numpy(pix[1]).to(DEV)].cpu().numpy()
	found = enmap.sky2pix(shape, wcs, np.array([res.cat.dec, res.cat.ra]))
	nx = shape[-1]
	def tree_pts(p):   # x wrapped onto [0, nx): the band is full-circle
		return np.array([p[0], np.mod(p[1], nx)]).T
	inj = tree_pts(pix.astype(float))
	fnd = tree_pts(found)
	# distances across the RA seam: also query shifted by +-nx
	def nearest(a, b):
		t = scipy.spatial.cKDTree(b)
		return np.min([t.query(a + [0, s])[0] for s in (-nx, 0, nx)], 0)
	want = sn_exp >= AN_FIND[0]
	miss = int(np.sum(nearest(inj[want], fnd) > AN_FIND[1])) if len(fnd) else int(want.sum())
	strong = res.cat.snr >= AN_FIND[0]
	spur = int(np.sum(nearest(fnd[strong], inj) > AN_FIND[1])) if strong.any() else 0
	print("analysis finder at full size: %d objects found (%d at S/N >= %g); of %d injected sources with expected "
		"S/N >= %g, %d not found within %g pixels; %d found at S/N >= %g not within %g pixels of an injected one"
		% (len(res.cat), int(strong.sum()), AN_FIND[0], int(want.sum()), AN_FIND[0], miss, AN_FIND[1], spur,
		AN_FIND[0], AN_FIND[1]))
	if miss or spur: failed.append("finder: %d missed, %d spurious" % (miss, spur))


def an_record(name, kind, replaces, err, ms, plain_ms, bound, library_ms, extra):
	rec = {"name": name, "route": "cuda", "source": DIST_SOURCE, "replaces": replaces, "launches": 0,
		"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
		"library_ms": library_ms, "kind": kind}
	rec.update(extra)
	return rec


def an_timed(fn):
	"""(fn(), its ms by CUDA events around one call)."""
	torch.cuda.synchronize()
	t0 = torch.cuda.Event(enable_timing=True)
	t1 = torch.cuda.Event(enable_timing=True)
	t0.record()
	out = fn()
	t1.record()
	torch.cuda.synchronize()
	return out, t0.elapsed_time(t1)


def an_device_ms(fn, pattern):
	"""(mean device ms a launch, launches) of the kernels matching pattern
	in one profiled call of fn."""
	from torch.profiler import profile, ProfilerActivity
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		fn()
		torch.cuda.synchronize()
	ka = prof.key_averages()
	ev = [e for e in ka if re.search(pattern, e.key)]
	count = sum(e.count for e in ev)
	return (sum(getattr(e, _device_key(ka)) for e in ev)/1e3/count if count else None), count


def an_pass_ms(seed, pd, pr, wrapx, steps):
	"""A K13 flood launch by launch with a CUDA event after each: (the ms of
	each of its 8 len(steps) passes and of the finish, the seeds, the
	distances). The host queues launches faster than they run, so the
	events measure the card."""
	from pixell_tpu_torch.ops import distances_cuda
	tabs = distances_cuda.tables("jump_flood", pd, pr, seed.shape, seed.device)
	passes = [(dy*step, dx*step) for step in steps for dy, dx in distances_cuda.OFFSETS]
	ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(passes) + 2)]
	bufs = [torch.empty_like(seed), torch.empty_like(seed)]
	s = seed
	torch.cuda.synchronize()
	ev[0].record()
	for i, (sy, sx) in enumerate(passes):
		s = distances_cuda.flood_pass(s, tabs, sy, sx, wrapx, bufs[i % 2])
		ev[i + 1].record()
	d = distances_cuda.flood_finish(s, tabs)
	ev[-1].record()
	torch.cuda.synchronize()
	return [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])], s, d


def an_pass_line(label, ms, nb):
	"""Prints the first 8 passes' mean ms a launch against the last 8's and
	the finish's, each beside the bytes bound nb (ms); returns them."""
	first, last, fin = float(np.mean(ms[:8])), float(np.mean(ms[-9:-1])), ms[-1]
	print("K13 passes %s: first 8 %.4f ms a launch, last 8 %.4f, finish %.4f, all %d %.4f on average (CUDA events; "
		"12 B bound %.4f ms: %.1f / %.1f / %.1f %%)" % (label, first, last, fin, len(ms), float(np.mean(ms)), nb,
		100*nb/first, 100*nb/last, 100*nb/fin))
	return {"first8_ms": first, "last8_ms": last, "finish_ms": fin}


def an_k14_ops(pd, pr, shape, npt):
	"""(K14's counted FP64 operations, the same at AN_PAIR_OPS_OLD a pair)
	for positions (pd, pr) broadcast to shape and npt points."""
	n = float(np.prod(shape))
	sep = pd.expand(shape).stride(1) == 0 and pr.expand(shape).stride(0) == 0   # as the kernel's separable()
	ops = n*(npt*AN_PAIR_OPS[sep] + AN_ANGLE_OPS) + (shape[1]*npt*AN_COLUMN_OPS if sep else 0)
	return ops, n*(npt*AN_PAIR_OPS_OLD + AN_ANGLE_OPS)


def an_records(bright, failed, errs, band):
	"""K13 and K14 timed on AN_REC_ROWS full-width rows of the band (its
	width, step list and RA wrap): per launch the kernel's device time, the
	plain version's time and the bound (bytes over 3.35 TB/s or the counted
	FP64 operations over 34 TFLOP/s); K13 launch by launch (the first 8
	passes against the last 8) on the rows and on the whole band; beside
	them each kernel's time a launch at the full band in the main path's profiled step
	(band_ms)."""
	from pixell_tpu_torch import enmap, distances
	from pixell_tpu_torch.ops import distances_cuda
	shape, wcs = an_geometry()
	y0 = shape[-2]//3
	cshape, cwcs = enmap.slice_geometry(shape, wcs, (slice(y0, y0 + AN_REC_ROWS), slice(None)))
	rng = np.random.default_rng(53)
	pd, pr = distances._positions(cshape, cwcs, DEV)
	steps, wrapx = distances._steps_for(max(cshape)), distances._is_wrapx(cshape, cwcs)
	n = int(np.prod(cshape))
	ny, nx = cshape
	seed = torch.where(torch.from_numpy(rng.uniform(size=cshape) < 1e-3).to(DEV),
		torch.arange(n, device=DEV, dtype=torch.int32).reshape(cshape), -1)
	nl = 1 + 8*len(steps)
	fn = lambda: distances_cuda.jump_flood(seed, pd, pr, wrapx, steps)
	sk, dk = fn()
	k_ms, count = an_device_ms(fn, "jump_flood_kernel")   # the mean over the launches the trace holds
	if 2*count < nl: failed.append("K13 record: %d launches traced of %d" % (count, nl))
	with an_plain():
		(sp, dp), p_ms = an_timed(fn)
	p_ms /= nl
	evals = []
	with an_plain(evals):
		fn()
	e13 = an_twin_check("K13 %s (records' cut) pixel seeds" % (cshape,), dk, dp, sk, sp, failed)
	# the function's state is the seed: 12 B a pixel a pass (its seed and the candidate's read, one
	# written; the finish reads a seed and writes a float64); a 24 B state would carry a float64 distance too
	tab_b = (2*ny + 3*nx)*8                    # the tables: (sin, cos) of dec; ra, (cos, sin) of ra
	nb = n*12 + tab_b
	ops = float(np.mean(evals))*AN_EVAL_OPS
	b13 = max((1e3*nb/PEAK_BYTES, "bytes"), (1e3*ops/PEAK_FLOPS[torch.float64], "operations"))
	b13_24 = 1e3*(n*24 + tab_b)/PEAK_BYTES
	ms, s_ev, d_ev = an_pass_ms(seed, pd, pr, wrapx, steps)
	rows_passes = an_pass_line("on %s" % (cshape,), ms, b13[0])
	if not (torch.equal(s_ev, sk) and torch.equal(d_ev, dk)): failed.append("K13 launch by launch differs")
	print("K13 row: jump_flood_kernel<int> on %s, %d launches a flood: %.4f ms a launch (profiler, %d launches "
		"traced), plain %.4f ms, bound %.4f ms (%s, 12 B a pixel; %.1f %%; with a 24 B state: %.4f ms, %.1f %%; %.1f M "
		"pixels evaluated a pass on average)" % (cshape, nl, k_ms, count, p_ms, b13[0], b13[1], 100*b13[0]/k_ms,
		b13_24, 100*b13_24/k_ms, np.mean(evals)/1e6))
	# K14 at the main path's 1000 points
	pt = torch.from_numpy(np.asarray(bright, np.float64)).to(DEV)
	fn = lambda: distances_cuda.nearest_point(pd, pr, pt[0], pt[1], cshape)
	ek, ik = fn()
	k14_ms, how = kernel_ms(fn, 3, "nearest_point_kernel")
	(ep, ip), p14_ms = an_timed(lambda: an_nearest_plain(pd, pr, pt, cshape, rows=32))
	e14 = an_twin_check("K14 %s (records' cut) %d points" % (cshape, pt.shape[1]), ek, ep, ik, ip, failed)
	nb = n*(8 + 4) + pt.shape[1]*56 + tab_b   # distance and domain written; the points' tables
	ops, ops_old = an_k14_ops(pd, pr, cshape, pt.shape[1])
	b14 = max((1e3*nb/PEAK_BYTES, "bytes"), (1e3*ops/PEAK_FLOPS[torch.float64], "operations"))
	old14 = 1e3*ops_old/PEAK_FLOPS[torch.float64]
	print("K14 row: nearest_point_kernel on %s, %d points: %.4f ms (%s), plain %.4f ms, bound %.4f ms (%s; %.1f %%; "
		"at the earlier %d operations a pair, not the bound: %.4f ms, %.1f %%)" % (cshape, pt.shape[1], k14_ms, how,
		p14_ms, b14[0], b14[1], 100*b14[0]/k14_ms, AN_PAIR_OPS_OLD, old14, 100*old14/k14_ms))
	bpd, bpr = distances._positions(shape, wcs, DEV)
	nband = float(np.prod(shape))
	bops, bops_old = an_k14_ops(bpd, bpr, tuple(shape), pt.shape[1])
	bb14, bb14_old = (1e3*o/PEAK_FLOPS[torch.float64] for o in (bops, bops_old))
	torch.cuda.empty_cache()
	# K13 launch by launch on the whole band, 1e-3 of its pixels seeds
	gen = torch.Generator(device=DEV)
	gen.manual_seed(59)
	bseed = torch.where(torch.rand(tuple(shape), generator=gen, device=DEV, dtype=torch.float32) < 1e-3,
		torch.arange(int(nband), device=DEV, dtype=torch.int32).reshape(tuple(shape)), -1)
	bb13 = 1e3*(nband*12 + (2*shape[0] + 3*shape[1])*8)/PEAK_BYTES
	bb13_24 = 1e3*(nband*24 + (2*shape[0] + 3*shape[1])*8)/PEAK_BYTES
	ms, _, _ = an_pass_ms(bseed, bpd, bpr, distances._is_wrapx(shape, wcs), distances._steps_for(max(shape)))
	band_passes = an_pass_line("on the band %s" % (tuple(shape),), ms, bb13)
	del bseed
	torch.cuda.empty_cache()
	band13, band14 = band
	print("analysis band %s: K13 %.4f ms a launch (bytes bound %.4f ms, 12 B a pixel: %.1f %%; 24 B: %.4f, %.1f %%), "
		"K14 %.4f ms (%d points; operations bound %.4f ms, %.1f %%; at the earlier %d operations a pair, not the "
		"bound: %.4f ms, %.1f %%), in the profiled step" % (tuple(shape), band13, bb13, 100*bb13/band13, bb13_24,
		100*bb13_24/band13, band14, pt.shape[1], bb14, 100*bb14/band14, AN_PAIR_OPS_OLD, bb14_old,
		100*bb14_old/band14))
	rec13 = {"shape": list(cshape), "band_ms": band13, "band_bound_ms": bb13, "bound_24B_ms": b13_24,
		"band_bound_24B_ms": bb13_24, "launches_a_flood": nl, "passes": rows_passes, "band_passes": band_passes}
	rec14 = {"shape": list(cshape), "npoint": int(pt.shape[1]), "band_ms": band14, "band_bound_ms": bb14,
		"bound_6ops_ms": old14, "band_bound_6ops_ms": bb14_old}
	return [an_record("jump_flood[int32]", "jump_flood", "pixell_tpu/distances.py:34", max(e13, errs["jump_flood"]),
			k_ms, p_ms, b13, None, rec13),
		an_record("nearest_point[float64]", "nearest_point", "pixell_tpu/distances.py:124",
			max(e14, errs["nearest_point"]), k14_ms, p14_ms, b14, None, rec14)]


def analysis_phase():
	"""Twins and exact guards, the chain against CPU tensors, then the
	DR6-sized band: the step timed (median of AN_NREP) with its stages, launches,
	busy share, memory and copies; the finder guard; the one-shot runs; the
	K13 / K14 records."""
	from pixell_tpu_torch import enmap, utils, pointsrcs, analysis, distances
	from pixell_tpu_torch.ops import distances_cuda
	h0 = time.perf_counter()
	AN_LAUNCHES.clear()
	failed = []
	errs = an_twins(failed)
	an_cpu_guard(failed)
	print("analysis guards done at %.1f s" % (time.perf_counter() - h0))
	shape, wcs = an_geometry()
	prof = an_profile()
	t0 = time.perf_counter()
	ny, nx = shape
	gen = torch.Generator(device=DEV)
	gen.manual_seed(23)
	y = torch.linspace(0, 1, ny, device=DEV, dtype=torch.float64)[:, None]
	x = torch.linspace(0, 1, nx, device=DEV, dtype=torch.float64)[None, :]
	ivar = ((1 + 0.5*torch.sin(2*np.pi*x)*torch.cos(np.pi*y))*4e4).to(torch.float32)   # smooth, per pixel
	noise = torch.randn(tuple(shape), generator=gen, device=DEV, dtype=torch.float32)*ivar**-0.5
	ivar = enmap.ndmap(ivar, wcs)
	finder, nmat = an_finder(shape, wcs, ivar, prof, DEV)
	zero = enmap.zeros(tuple(shape), wcs, torch.float32, device=DEV)
	kappa = nmat.matched_filter(zero)[1].data
	cat = an_catalogue(shape, wcs, kappa)
	del zero, kappa
	torch.cuda.empty_cache()
	print("analysis band %s: set-up (UHT, beam and iC planes, kappa, catalogue) %.1f s; %d sources, S/N %.1f-%.1f; "
		"%d bright" % (tuple(shape), time.perf_counter() - t0, len(cat[1]), cat[2].min(), cat[2].max(), AN_NBRIGHT))
	args = (shape, wcs, cat[:2] + (cat[3],), noise, prof, finder, DEV, torch.float32, AN_BRIGHT_R*utils.arcmin,
		AN_APOD*utils.degree)
	torch.cuda.reset_peak_memory_stats()
	t0 = time.perf_counter()
	# the first step: driven with the counts at 0, profiled (busy share, device time by kernel, copies)
	((keep, apod, res, filled), wall, busy, band), launches = an_drive("band step", lambda: an_profile_step(
		lambda: an_step(*args), "band step"))
	print("analysis band: first step %.1f s (wall, profiled)" % (time.perf_counter() - t0))
	peak = torch.cuda.max_memory_allocated()/2**30
	ok = bool(torch.isfinite(filled.data).all()) and bool(torch.isfinite(apod.data).all()) \
		and tuple(filled.shape) == tuple(shape) and 0 < float(keep.float().mean()) < 1
	print("analysis band: inpainted map %s %s, apod in [%.3f, %.3f], %.4f %% masked by the bright sources; "
		"peak device memory %.2f GiB (bound %d)" % (tuple(filled.shape), filled.dtype, float(apod.data.min()),
		float(apod.data.max()), 100*(1 - float(keep.float().mean())), peak, FLAT_MEM_GIB))
	if not ok: failed.append("band step: outputs not finite or of the wrong shape")
	if not peak < FLAT_MEM_GIB: failed.append("band step: peak %.2f GiB" % peak)
	if not (launches["jump_flood"] and launches["nearest_point"]): failed.append("band step launches %s" % launches)
	an_find_guard(res, cat, apod, failed)
	del keep, apod, res, filled
	torch.cuda.empty_cache()
	steps, stages, hosts = [], [], []
	for it in range(AN_NREP):
		marks = []
		analysis.reset_host_ms()
		out = an_step(*args, marks=marks)
		torch.cuda.synchronize()
		hosts.append(dict(analysis.HOST_MS))
		del out
		stages.append([a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])])
		steps.append(marks[0].elapsed_time(marks[-1]))
	med = float(np.median(steps))
	print("analysis band step: %.3f ms (median of %d; min %.3f, max %.3f)" % (med, AN_NREP, min(steps), max(steps)))
	for j, name in enumerate(("srcsim", "mask (K14)", "apod (K13)", "find", "inpaint (K13)")):
		v = [s[j] for s in stages]
		print("analysis band stage %s: %.3f ms (median of %d; min %.3f, max %.3f), %.1f %% of the step" % (name,
			float(np.median(v)), len(v), min(v), max(v), 100*float(np.median(v))/med))
	for name in analysis.HOST_STAGES:
		v = [h[name] for h in hosts]
		print("analysis band host stage %s (inside find): %.3f ms wall (median of %d; min %.3f, max %.3f)" % (name,
			float(np.median(v)), len(v), min(v), max(v)))
	torch.cuda.empty_cache()
	# one-shot runs: sim_srcs_dist_transform of every source (> 1024: K13), HEALPix at nside 2048
	srcs = np.array([cat[0][0], cat[0][1], cat[1]]).T
	t0 = time.perf_counter()
	(dt, _) = an_drive("sim_srcs_dist_transform of %d sources" % AN_NSRC, lambda: pointsrcs.sim_srcs_dist_transform(
		shape, wcs, srcs, (prof[0], prof[1]), dtype=np.float64, device=DEV))
	print("analysis sim_srcs_dist_transform: %.1f s (wall, once)" % (time.perf_counter() - t0))
	r, b = prof
	sigma_eff = r[np.argmin(np.abs(b - b[0]*np.exp(-0.5)))]
	so = pointsrcs.sim_objects(shape, wcs, cat[0], cat[1], prof, dtype=np.float64, rmax=4*max(sigma_eff, r[1]),
		vmin=1e-30, device=DEV)
	on = dt.data != 0
	top = float(so.data.abs().max())
	e = float((dt.data - so.data).abs()[on].max())/top
	rim = float(so.data.abs()[~on].max())/top
	print("analysis sim_srcs_dist_transform against sim_objects (the same rmax; no two sources' disks overlap): "
		"rel err %.3e where it paints (bound %.0e), sim_objects' values beyond its disks up to %.3e of the largest "
		"(bound %.0e)" % (e, AN_DT_TOL[0], rim, AN_DT_TOL[1]))
	if not (e <= AN_DT_TOL[0] and rim <= AN_DT_TOL[1]):
		failed.append("sim_srcs_dist_transform against sim_objects %g, %g" % (e, rim))
	del dt, so
	torch.cuda.empty_cache()
	info = distances.healpix_info(AN_HP[1])
	hp = {}
	for method in ("brute", "grid"):
		t0 = time.perf_counter()
		(hp[method], _) = an_drive("distance_from_points_healpix nside %d %s, %d points" % (AN_HP[1], method,
			AN_NBRIGHT), lambda: distances.distance_from_points_healpix(info, cat[3], method=method, device=DEV))
		print("analysis HEALPix nside %d %s: %.3f s (wall, once)" % (AN_HP[1], method, time.perf_counter() - t0))
	below = float((hp["brute"] - hp["grid"]).max())
	share = float(((hp["grid"] - hp["brute"]).abs() <= AN_EXACT_TOL).double().mean())
	print("analysis HEALPix nside %d: grid (K13) shorter than brute (K14) by at most %.3e rad (bound %.0e); %.5f %% "
		"within %.0e" % (AN_HP[1], below, AN_EXACT_TOL, 100*share, AN_EXACT_TOL))
	if not below <= AN_EXACT_TOL: failed.append("HEALPix grid shorter than brute by %g" % below)
	del hp
	torch.cuda.empty_cache()
	recs = an_records(cat[3], failed, errs, band)
	for rec in recs: rec["launches"] = rec["analysis_launches"] = launches[rec["kind"]]
	print("analysis launches in all its paths (each driven with the counts at 0): %s" % AN_LAUNCHES)
	print("analysis phase: %.1f s" % (time.perf_counter() - h0))
	if failed: raise RuntimeError("analysis guards failed:\n" + "\n".join(failed))
	return recs


# ---------------------------------------------------------------------------
# the mesh phase: multi-device maps and transforms (parallel/, tilemap, the
# m block of K1-K4)
# ---------------------------------------------------------------------------
MESH_R = 4                       # emulated ranks of the ring-sharded roundtrip
MESH_LMAX = 2000
MESH_SHAPE = (2160, 4320)
# f64 bounds, of the largest value: tests/test_parallel.py's. The emulated ranks' ring-sharded synthesis
# (K3 on each ring block) is held to "synthesis" against K3 on the whole ring set (no_sym), and to
# "emulated" against one device, whose symmetric ring set takes K1 (another summation order; K1 alone
# is 2.7e-11 from the float64 plain version in spin 2 at lmax 2000, the kernels phase): the roundtrip's
# bound, printed beside the distance of K3 on the whole ring set from K1, its control
MESH_TOL = {"synthesis": 1e-12, "analysis": 1e-11, "rect": 1e-11, "lensing": 1e-10, "wavelets": 1e-10,
	"emulated": 1e-11}
# the kernel checks' m block: lmax, the block's first m (not a multiple of TILE_M), its columns, the rings
MESH_CHECK = (300, 101, 29, 64)
MESH_LAUNCHES = {}               # the m-block launches of the mesh phase's main path, by (kernel, mode, dtype)


def mesh_cols(name, x, m0, m1):
	"""Columns m0 .. m1 - 1 of kernel name's input or output x."""
	from pixell_tpu_torch.ops.sht_core import NFUN
	axis = {"sym_analysis": 3, "full_analysis": 2, "polar_analysis": 2}.get(name, 1)
	if name.endswith("analysis") and x.ndim == 3: axis = 1      # an analysis output [nl, nm, C]
	if name.endswith("synthesis") and x.ndim != 3: axis = x.ndim - 2   # a synthesis output [.., nm, nt]
	return x.narrow(axis, m0, m1 - m0).contiguous()


def mesh_kernel_checks(failed):
	"""Each of K1-K4 (K7 in wigner mode) in float32 and float64, and the
	near-pole passes, in the modes the mesh paths give them, on an m block
	that starts off the m tile (MESH_CHECK): held against its plain twin on
	the same block (the kernel phase's bounds: float64 1e-11 / 1e-10,
	float32 twice the float32 plain version's error plus 1e-6, each against
	the float64 plain version; float32 with the block's dead-tile stops) and
	against the same columns of the whole launch (without stops, so that
	both compute every entry: equal). Returns {(wrapper, mode, dtype):
	(plain ms, rel err, max abs err)}."""
	from pixell_tpu_torch import sht
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	lmax, m0, nb, nt = MESH_CHECK
	m1 = m0 + nb
	full = np.sort(np.random.default_rng(71).uniform(0.02, np.pi - 0.02, nt))
	north = sht.ring_theta("F1", 2*nt)[:nt]
	polar = np.concatenate([np.linspace(0.001, 0.08, 8), np.pi - np.linspace(0.001, 0.08, 8)[::-1]])
	cases = [("sym_synthesis", m, north) for m in ("scalar", "spin2")] \
		+ [("sym_analysis", m, north) for m in ("scalar", "spin2")] \
		+ [(k, m, full) for k in ("full_synthesis", "full_analysis") for m in ("scalar", "deriv", "spin2", "wigner")] \
		+ [(k, m, polar) for k in ("polar_synthesis", "polar_analysis") for m in ("scalar", "spin2")]
	out = {}
	for i, (name, mode, theta) in enumerate(cases):
		s, kern, plain = mode_spin(mode), getattr(sht_cuda, name), sht_cuda.PLAIN[name]
		base = name.replace("polar", "full")
		x = torch.from_numpy(kernel_input(base, mode, lmax, lmax, len(theta), 90 + i)).to(dev)
		xb = mesh_cols(name, x, m0, m1)
		gb64 = sht_cuda.geom(theta, m1 - 1, torch.float64, dev, s, m0)
		ref, plain64_ms = timed_once(lambda: plain(xb, gb64, lmax, mode))
		for dt in ((torch.float64,) if name.startswith("polar") else (torch.float64, torch.float32)):
			gw, gb = sht_cuda.geom(theta, lmax, dt, dev, s), sht_cuda.geom(theta, m1 - 1, dt, dev, s, m0)
			whole = kern(x.to(dt), gw, lmax, mode)
			blk = kern(xb.to(dt), gb, lmax, mode)
			torch.cuda.synchronize()
			dwhole = float((blk - mesh_cols(name, whole, m0, m1)).abs().max())
			if dt == torch.float64:
				err, tol, perr, pms = relerr(blk, ref), (1e-11 if mode == "scalar" else 1e-10), 0.0, plain64_ms
			else:
				stops = None
				if not name.startswith("sym_analysis"):
					stops = sht_cuda.dead_stops(theta, lmax, m1 - 1, s or 0, dev, m0)
				args = (xb.to(dt), gb, lmax, mode) + (() if stops is None else (stops,))
				blk = kern(*args)
				p, pms = timed_once(lambda: plain(*args))
				err, perr = relerr(blk, ref), relerr(p, ref)
				tol = 2*perr + 1e-6
			ok = err <= tol and dwhole == 0 and bool(torch.isfinite(blk).all())
			print("m block %-15s %-6s %s: lmax %d, m %d .. %d (of %d), nt %d: rel err %.3e against the float64 "
				"plain version on the block (plain %.3e, bound %.3e); the whole launch's columns %s %s" % (name,
				mode, str(dt)[6:], lmax, m0, m1 - 1, lmax + 1, len(theta), err, perr, tol,
				"equal" if dwhole == 0 else "differ by %.3e" % dwhole, "ok" if ok else "FAIL"))
			if not ok: failed.append("m block %s %s %s" % (name, mode, dt))
			out[(name, mode, str(dt)[6:])] = (pms, err, float((blk.double() - ref).abs().max()))
	return out


class no_sym:
	"""Within the block the dispatch treats no ring set as north / south
	symmetric: K3 / K4 on the whole ring set where it would take K1 / K2."""
	def __enter__(self):
		from pixell_tpu_torch.ops import sht_cuda
		self.detect = sht_cuda.detect_sym
		sht_cuda.detect_sym = lambda theta: None
	def __exit__(self, *exc):
		from pixell_tpu_torch.ops import sht_cuda
		sht_cuda.detect_sym = self.detect


def mesh_rank_ms(fn):
	"""(result, ms): fn() once to warm up (its tables), then once timed with CUDA events."""
	fn()
	return timed_once(fn)


def mesh_iqu(dtype, ref=None):
	"""The emulated MESH_R ranks' IQU alm2map -> map2alm at MESH_LMAX on the
	MESH_SHAPE Fejer-1 map in dtype, each rank's work in turn on the card:
	synthesis on its ring block (sht_dist._synthesis_local: K3, a block
	not north / south symmetric), the ring FFTs of its rows, the all-to-all
	by slicing, the 2d phase path's theta upsample and quadrature on its m
	block (curvedsky._phase_block: K4 with the block's first m), the
	all-gather by concatenation; held against the one-device alm2map and
	map2alm (float64: MESH_TOL; float32 with ref, the float64 results: the
	float32 rule). Returns (map, alm, rows)."""
	from pixell_tpu_torch import enmap, curvedsky, sht
	from pixell_tpu_torch.parallel import sht_dist, mesh as pmesh
	R, lmax = MESH_R, MESH_LMAX
	cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
	shape, wcs = enmap.fullsky_geometry(shape=MESH_SHAPE, variant="fejer1")
	alm = curvedsky.rand_alm(spectrum(lmax, (0, 2)), lmax=lmax, seed=61, device="cuda").to(cdt)
	ainfo = curvedsky.alm_info(lmax=lmax)
	minfo = curvedsky.analyse_geometry((3,) + shape, wcs)
	nm, ny, nphi = lmax + 1, shape[0], minfo.nphi
	z = lambda: enmap.zeros((3,) + shape, wcs, dtype, device="cuda")
	m1, one_syn = mesh_rank_ms(lambda: curvedsky.alm2map(alm, z(), spin=[0, 2]))
	a1, one_ana = mesh_rank_ms(lambda: curvedsky.map2alm(m1, lmax=lmax, spin=[0, 2]))
	synth = lambda r: sht_dist._synthesis_local(alm, minfo.theta, nphi, r, R, phi0=minfo.phi0, lmax=lmax,
		mmax=lmax, spin=(0, 2), map_dtype=dtype)
	d = curvedsky._to_rings(m1.data, minfo)
	def rows_fft(r):
		t0, t1 = pmesh.block(ny, R, r)
		return sht.ring_analysis(d[..., t0:t1, :], minfo.phi0, nm)
	from pixell_tpu_torch.ops import sht_cuda
	sht_cuda.reset_launches()
	parts, fparts, rows = [], [], []
	for r in range(R):
		(p, syn_ms), (f, fft_ms) = mesh_rank_ms(lambda: synth(r)), mesh_rank_ms(lambda: rows_fft(r))
		parts.append(p); fparts.append(f)
		rows.append({"rank": r, "synthesis_ms": syn_ms, "ring_fft_ms": fft_ms,
			"map_rows_bytes": p.numel()*p.element_size(), "alm_bytes": alm.numel()*alm.element_size()})
	F = torch.cat(fparts, -1)                  # the all-to-all, by slicing: each rank's m block on every ring
	rects = []
	for r in range(R):
		b0, b1 = pmesh.block(nm, R, r)
		Fb = F[..., b0:b1, :].contiguous()
		rect, ana_ms = mesh_rank_ms(lambda: curvedsky._phase_block(Fb, b0, ainfo, minfo, (0, 2), False, nphi, 3))
		rects.append(rect)
		rows[r].update({"m_block": [b0, b1], "analysis_ms": ana_ms, "rect_bytes": rect.numel()*rect.element_size(),
			"phase_bytes": Fb.numel()*Fb.element_size()})
	mblock = {k: n for k, n in sht_cuda.LAUNCHES_MBLOCK.items() if n}
	for k, n in mblock.items(): MESH_LAUNCHES[k] = MESH_LAUNCHES.get(k, 0) + n
	dm = curvedsky._from_rings(torch.cat(parts, -2), minfo, shape[-1])
	da = sht.rect2alm(torch.cat(rects, -1), lmax, lmax)
	tag = "IQU lmax %d %s %s, %d emulated ranks" % (lmax, MESH_SHAPE, str(dtype)[6:], R)
	for r in rows:
		print("mesh rank %d of %s: synthesis of rows %d .. %d %.3f ms, their ring FFTs %.3f ms, the m block %d .. "
			"%d's upsample and quadrature %.3f ms; holds alm %.1f MB (replicated), map rows %.1f MB, phases of "
			"its m block %.1f MB, rect of its m block %.1f MB" % (r["rank"], tag, *pmesh.block(ny, R, r["rank"]),
			r["synthesis_ms"], r["ring_fft_ms"], r["m_block"][0], r["m_block"][1] - 1, r["analysis_ms"],
			r["alm_bytes"]/1e6, r["map_rows_bytes"]/1e6, r["phase_bytes"]/1e6, r["rect_bytes"]/1e6))
	slow_syn, slow_ana = max(r["synthesis_ms"] for r in rows), max(r["ring_fft_ms"] + r["analysis_ms"] for r in rows)
	print("mesh %s: slowest rank alm2map %.3f ms against one device %.3f ms; map2alm %.3f ms against %.3f ms "
		"(contiguous m blocks are not balanced: block 0 holds the most degrees); m-block launches %s" % (tag,
		slow_syn, one_syn, slow_ana, one_ana, mblock))
	if ref is None:
		with no_sym(): mk3 = curvedsky.alm2map(alm, z(), spin=[0, 2]).data
		ek3, es, ctl, ea = relerr(dm, mk3), relerr(dm, m1.data), relerr(mk3, m1.data), relerr(da, a1)
		ok = ek3 <= MESH_TOL["synthesis"] and es <= MESH_TOL["emulated"] and ea <= MESH_TOL["analysis"]
		print("mesh %s: map against K3 on the whole ring set %.3e (bound %.0e), against one device (K1) %.3e "
			"(bound %.0e; K3 on the whole ring set against K1, the control, %.3e); alm against one device %.3e "
			"(bound %.0e) %s" % (tag, ek3, MESH_TOL["synthesis"], es, MESH_TOL["emulated"], ctl, ea,
			MESH_TOL["analysis"], "ok" if ok else "FAIL"))
		del mk3
	else:
		es, eo = relerr(dm, ref[0]), relerr(m1.data, ref[0])
		ea, eao = relerr(da, ref[1]), relerr(a1, ref[1])
		ok = es <= 2*eo + 1e-6 and ea <= 2*eao + 1e-6
		print("mesh %s against the float64 one-device results: map %.3e (one device %.3e, bound %.3e), alm %.3e "
			"(one device %.3e, bound %.3e) %s" % (tag, es, eo, 2*eo + 1e-6, ea, eao, 2*eao + 1e-6,
			"ok" if ok else "FAIL"))
	if not mblock:
		raise RuntimeError("mesh %s: no launch on an m block" % tag)
	summary = {"one_device_alm2map_ms": one_syn, "one_device_map2alm_ms": one_ana, "slowest_alm2map_ms": slow_syn,
		"slowest_map2alm_ms": slow_ana, "ranks": rows, "ok": ok}
	return dm, da, summary


def mesh_step(lmax, dtype, ref=None):
	"""roundtrip_step(shard="m") of parallel.sht_dist on a 2 x 2 mesh
	("rows", "cols"), emulated: the two row ranks' ring FFTs, the all-to-all
	by slicing, the two column ranks' m blocks (K2 / K4 and K1 / K3 with the
	block's first m) with the per-l filter, the all-to-all back, the row
	ranks' ring syntheses; against the one-device ring roundtrip (float64:
	MESH_TOL["rect"]; float32 with ref, the float64 map: the float32 rule).
	Returns (map, summary)."""
	from pixell_tpu_torch import sht, curvedsky
	from pixell_tpu_torch.parallel import sht_dist, mesh as pmesh
	from pixell_tpu_torch.ops import sht_cuda
	nt, nphi = 2*lmax + 2, 2*lmax + 4
	theta, w = sht.ring_theta("F1", nt), sht.ring_weights("F1", nt)
	maps = torch.from_numpy(np.random.default_rng(62).standard_normal((3, nt, nphi))).to("cuda", dtype)
	l = np.arange(lmax + 1)
	flh = np.exp(-0.5*l*(l + 1)*0.01**2)
	fl = torch.as_tensor(flh, dtype=dtype, device="cuda")
	mpad = sht_dist._pad_mmax(lmax, lmax, 2)
	def one():
		a = curvedsky.almxfl(sht.analysis(maps, theta, lmax, w, spin=(0, 2)), flh, ainfo=curvedsky.alm_info(lmax=lmax))
		return sht.synthesis(a, theta, nphi, lmax=lmax, spin=(0, 2))
	om1, one_ms = mesh_rank_ms(one)
	sht_cuda.reset_launches()
	F = torch.cat([sht.ring_analysis(maps[..., slice(*pmesh.block(nt, 2, r)), :], 0.0, mpad + 1) for r in range(2)], -1)
	G, cols = [], []
	for c in range(2):
		b0, b1 = pmesh.block(mpad + 1, 2, c)
		Fc = F[:, b0:b1].contiguous()
		def col():
			rect = sht_dist._analysis_m_local(Fc, theta, lmax, w, nphi, b0, lmax, (0, 2))*fl[:, None]
			return sht_dist._synthesis_m_local(rect, theta, lmax, b0, (0, 2))
		g, ms = mesh_rank_ms(col)
		G.append(g)
		cols.append({"m_block": [b0, b1], "ms": ms, "rect_bytes": 3*(lmax + 1)*(b1 - b0)*2*maps.element_size()})
	G = torch.cat(G, -2)
	om = torch.cat([sht.ring_synthesis(G[..., slice(*pmesh.block(nt, 2, r))], 0.0, nphi).to(dtype) for r in range(2)], -2)
	mblock = {k: n for k, n in sht_cuda.LAUNCHES_MBLOCK.items() if n}
	for k, n in mblock.items(): MESH_LAUNCHES[k] = MESH_LAUNCHES.get(k, 0) + n
	tag = "roundtrip_step(shard=\"m\") lmax %d (%d x %d) %s on a 2 x 2 mesh, emulated" % (lmax, nt, nphi,
		str(dtype)[6:])
	for c in cols:
		print("mesh column rank of %s: m %d .. %d, its analysis, filter and Legendre synthesis %.3f ms, holds rect "
			"%.1f MB of the whole %.1f MB" % (tag, c["m_block"][0], c["m_block"][1] - 1, c["ms"], c["rect_bytes"]/1e6,
			3*(lmax + 1)*(mpad + 1)*2*maps.element_size()/1e6))
	if ref is None:
		err = relerr(om, om1)
		ok = err <= MESH_TOL["rect"]
		print("mesh %s: against one device %.3e (bound %.0e), one device %.3f ms, slowest column %.3f ms; m-block "
			"launches %s %s" % (tag, err, MESH_TOL["rect"], one_ms, max(c["ms"] for c in cols), mblock,
			"ok" if ok else "FAIL"))
	else:
		err, eo = relerr(om, ref), relerr(om1, ref)
		ok = err <= 2*eo + 1e-6
		print("mesh %s: against the float64 one-device map %.3e (one device %.3e, bound %.3e), one device %.3f ms, "
			"slowest column %.3f ms; m-block launches %s %s" % (tag, err, eo, 2*eo + 1e-6, one_ms,
			max(c["ms"] for c in cols), mblock, "ok" if ok else "FAIL"))
	if not mblock:
		raise RuntimeError("mesh %s: no launch on an m block" % tag)
	return om1 if ref is None else None, {"one_device_ms": one_ms, "columns": cols, "ok": ok}


def mesh_public(failed):
	"""The public entry points on a one-rank NCCL mesh (parallel.mesh.get_mesh
	on "cuda"), each against the same call without the mesh: curvedsky
	alm2map / map2alm of IQU and deriv=True at MESH_LMAX (float64),
	WaveletTransform(UHT(mode="curved", lmax=MESH_LMAX), mesh=) map2wave ->
	wave2map, lens_map_curved(mesh=) at config 4's size (float64), and
	tilemap from_enmap -> distribute -> redistribute -> to_enmap of the
	DR6-sized band, IQU f32, in 500 x 500 tiles (exact)."""
	import torch.distributed as tdist
	from pixell_tpu_torch import enmap, curvedsky, uharm, wavelets, lensing, tilemap, utils
	from pixell_tpu_torch.parallel import mesh as pmesh
	mesh = pmesh.get_mesh(device="cuda")
	if tdist.get_backend() != "nccl": raise RuntimeError("the CUDA mesh runs on %s" % tdist.get_backend())
	try:
		return mesh_public_paths(mesh, failed)
	finally:
		tdist.destroy_process_group()


def mesh_public_paths(mesh, failed):
	"""mesh_public's calls on the one-rank mesh."""
	from pixell_tpu_torch import enmap, curvedsky, uharm, wavelets, lensing, tilemap, utils
	from pixell_tpu_torch.parallel import mesh as pmesh
	lmax = MESH_LMAX
	shape, wcs = enmap.fullsky_geometry(shape=MESH_SHAPE, variant="fejer1")
	alm = curvedsky.rand_alm(spectrum(lmax, (0, 2)), lmax=lmax, seed=63, device="cuda")
	z = lambda pre: enmap.zeros(pre + shape, wcs, torch.float64, device="cuda")
	res = []
	def held(label, got, want, tol):
		err = relerr(got, want)
		res.append((label, err, tol))
		print("mesh public %s on a one-rank NCCL mesh against no mesh: %.3e (bound %.0e) %s" % (label, err, tol,
			"ok" if err <= tol else "FAIL"))
		if not err <= tol: failed.append("mesh public " + label)
	m1 = curvedsky.alm2map(alm, z((3,)), spin=[0, 2])
	held("alm2map IQU lmax %d" % lmax, curvedsky.alm2map(alm, z((3,)), spin=[0, 2], mesh=mesh).data, m1.data,
		MESH_TOL["synthesis"])
	held("map2alm IQU lmax %d" % lmax, curvedsky.map2alm(m1, lmax=lmax, spin=[0, 2], mesh=mesh),
		curvedsky.map2alm(m1, lmax=lmax, spin=[0, 2]), MESH_TOL["analysis"])
	g1 = curvedsky.alm2map(alm[0], z((2,)), deriv=True)
	held("alm2map deriv", curvedsky.alm2map(alm[0], z((2,)), deriv=True, mesh=mesh).data, g1.data, MESH_TOL["synthesis"])
	held("map2alm deriv", curvedsky.map2alm(g1, lmax=lmax, deriv=True, mesh=mesh),
		curvedsky.map2alm(g1, lmax=lmax, deriv=True), MESH_TOL["analysis"])
	wt = wavelets.WaveletTransform(uharm.UHT(shape, wcs, mode="curved", lmax=lmax, device="cuda"))
	wm = wavelets.WaveletTransform(uharm.UHT(shape, wcs, mode="curved", lmax=lmax, mesh=mesh, device="cuda"))
	w1, w2 = wt.map2wave(m1[0]), wm.map2wave(m1[0])
	held("map2wave (%d scales)" % len(w1.maps), torch.cat([m.data.reshape(-1) for m in w2.maps]),
		torch.cat([m.data.reshape(-1) for m in w1.maps]), MESH_TOL["wavelets"])
	held("wave2map", wm.wave2map(w2).data, wt.wave2map(w1).data, MESH_TOL["wavelets"])
	del w1, w2, wt, wm
	# config 4's spectra on white alm drawn on the card (lensing.rand_alm draws on the host, ~7 s at lmax 4000)
	ainfo = curvedsky.alm_info(lmax=LENS_LMAX)
	gen = torch.Generator(device="cuda").manual_seed(64)
	white = lambda n: torch.randn((n, ainfo.nelem), dtype=torch.complex128, device="cuda", generator=gen)
	ps = np.sqrt(np.diagonal(lens_spectra(LENS_LMAX)).T)            # [4, nl]
	phi = curvedsky.almxfl(white(1)[0], ps[0], ainfo=ainfo)
	cmb = torch.stack([curvedsky.almxfl(a, p, ainfo=ainfo) for a, p in zip(white(3), ps[1:])])
	lshape, lwcs = lens_config4_geometry()
	kw = dict(shape=(3,) + tuple(lshape), wcs=lwcs, phi_alm=phi, cmb_alm=cmb, dtype=np.float64,
		delta_theta=LENS_DTHETA*utils.degree)
	held("lens_map_curved config 4", lensing.lens_map_curved(mesh=mesh, **kw).data,
		lensing.lens_map_curved(**kw).data, MESH_TOL["lensing"])
	del phi, cmb
	bshape, bwcs = an_geometry()
	band = enmap.ndmap(torch.randn((3,) + tuple(bshape), dtype=torch.float32, device="cuda"), bwcs)
	t0 = time.perf_counter()
	tm = tilemap.from_enmap(band, (500, 500))
	dtm = tilemap.distribute(tm, mesh)
	rtm = tilemap.redistribute(dtm, sharding=pmesh.replicated(mesh))
	back = tilemap.to_enmap(tilemap.redistribute(rtm, mesh, axis="rows"))
	torch.cuda.synchronize()
	same = bool(torch.equal(back.data, band.data))
	print("mesh public tilemap of the DR6-sized band %s IQU f32 in 500 x 500 tiles (%d tiles): from_enmap -> "
		"distribute -> redistribute -> to_enmap %.1f ms, %s" % (tuple(bshape), tm.nactive,
		1e3*(time.perf_counter() - t0), "equal" if same else "FAIL"))
	if not same: failed.append("mesh public tilemap")
	del band, tm, dtm, rtm, back
	torch.cuda.empty_cache()
	return res


def mesh_records(checks):
	"""The m-block records of the kernels line: each of K1-K4 in float32 and
	float64 in spin2, at the block and ring set of the mesh paths' launches
	(K4 on rank 1's m block of the IQU analysis, 501 .. 1001, on the first
	2048-ring chunk of the 4032 upsampled rings; K3 on column rank 1's block
	of the 2 x 2 step at lmax 2000, 1001 .. 2001 of the padded 2002, all
	4002 rings; K1 / K2 on column rank 1's block at lmax 750, 376 .. 751 of
	752, the 751 northern of 1502 rings): the block's kernel time beside the
	whole launch's on the same rings, the bound of the block's work, the
	chunked torch.bmm yardstick, the plain twin's time at the check's shape
	(mesh_kernel_checks: the plain version at this shape would take
	minutes), the launches from the mesh path's run."""
	from pixell_tpu_torch import sht, fft
	from pixell_tpu_torch.ops import sht_cuda
	dev = torch.device("cuda")
	up = sht.ring_theta("F1", fft.fft_len(2*MESH_LMAX + 3, direction="above"))
	nn, ns = sht_cuda.polar_counts(up, MESH_LMAX)
	th750 = sht.ring_theta("F1", 1502)
	cases = [("full_analysis", MESH_LMAX, 501, 1002, {torch.float32: up[nn:len(up) - ns][:sht_cuda.TCHUNK],
			torch.float64: up[:sht_cuda.TCHUNK]}),
		("full_synthesis", MESH_LMAX, 1001, 2002, sht.ring_theta("F1", 2*MESH_LMAX + 2)),
		("sym_synthesis", 750, 376, 752, th750[:751]),
		("sym_analysis", 750, 376, 752, th750[:751])]
	records = []
	mode, C = "spin2", ncoef("spin2")
	for name, lmax, m0, m1, rings in cases:
		kern = getattr(sht_cuda, name)
		tables = {}   # by ring set: the mode-function table of the rows m < 64, float64
		for dt in (torch.float32, torch.float64):
			theta = rings[dt] if isinstance(rings, dict) else rings
			nt, esize = len(theta), (4 if dt == torch.float32 else 8)
			mmax = max(m1 - 1, lmax)
			x = torch.from_numpy(kernel_input(name, mode, lmax, mmax, nt, 95)).to(dev, dt)
			xb = mesh_cols(name, x, m0, m1)
			gw = sht_cuda.geom(theta, mmax, dt, dev)
			gb = sht_cuda.geom(theta, m1 - 1, dt, dev, None, m0)
			sw = sb = None
			if dt == torch.float32 and name != "sym_analysis":
				sw = sht_cuda.dead_stops(theta, lmax, mmax, 0, dev)
				sb = sht_cuda.dead_stops(theta, lmax, m1 - 1, 0, dev, m0)
			argb = (xb, gb, lmax, mode) + (() if sb is None else (sb,))
			argw = (x, gw, lmax, mode) + (() if sw is None else (sw,))
			pat = kernel_pattern(name, dt)
			ms, how = kernel_ms(lambda: kern(*argb), 5, pat)
			whole_ms, _ = kernel_ms(lambda: kern(*argw), 5, pat)
			b_ms, b_by = bound(kernel_ops(name, mode, lmax, m1 - 1, nt, C, sb, m0=m0),
				kernel_bytes(name, mode, lmax, m1 - 1, nt, C, esize, m0=m0), dt)
			tkey = len(theta)
			if tkey not in tables:
				tables[tkey] = library_call(name, mode, mesh_cols(name, xb, 0, 64).double(), theta, 63, lmax)[0]
			lib_ms = chunked_bmm_ms(tables[tkey].to(dt), library_operand(name, mode, xb, nt)[0], 64)
			key = (name, mode, str(dt)[6:])
			plain_ms, err, abs_err = checks[key]
			entry = (sht_cuda.BULK_F64 if dt == torch.float64 else sht_cuda.BULK_KERNELS)[name]
			launches = MESH_LAUNCHES.get((entry, mode, str(dt)[6:]), 0)
			rec = {"name": "%s[m block, %s, lmax %d, m %d-%d of %d, nt %d]" % (entry, mode, lmax, m0, m1 - 1,
				mmax + 1, nt), "route": "cuda", "source": LEGENDRE_SOURCE, "replaces": REPLACES[name], "mode": mode,
				"launches": launches, "max_abs_err": abs_err, "rel_err": err, "ms": ms, "ms_from": how,
				"whole_ms": whole_ms, "plain_ms": plain_ms,
				"plain_shape": "lmax %d, m %d .. %d, nt %d (mesh_kernel_checks; max_abs_err and rel_err there, "
					"against the float64 plain version)" % (MESH_CHECK[0], MESH_CHECK[1],
					MESH_CHECK[1] + MESH_CHECK[2] - 1, MESH_CHECK[3]),
				"bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
				"library_from": "torch.bmm over the block's m in chunks of 64 rows, times summed, with the table of "
					"the rows m < 64 (a dense product's time does not depend on its values; the yardstick's "
					"function is held in the lstop phase and the float64 rows)",
				"shape": "lmax %d, m %d .. %d, nt %d, C %d, %s%s" % (lmax, m0, m1 - 1, nt, C, str(dt)[6:],
					"" if sb is None else ", dead-tile table")}
			print("time   m block %-14s %s %s: %s %.4f ms (%s) against the whole launch's %.4f ms (m 0 .. %d), bound "
				"%.4f ms (%s, %.1f %% of it reached), torch.bmm in chunks %.4f ms; launches on the mesh path %d" % (
				name, mode, rec["shape"], entry, ms, how, whole_ms, mmax, b_ms, b_by, 100*b_ms/ms, lib_ms, launches))
			records.append(rec)
			del x, xb
			torch.cuda.empty_cache()
		del tables
	return records


def mesh_phase():
	"""The mesh phase (13. above). Returns the m-block records."""
	h0 = time.perf_counter()
	MESH_LAUNCHES.clear()
	failed = []
	checks = mesh_kernel_checks(failed)
	print("mesh kernel checks done at %.1f s" % (time.perf_counter() - h0))
	m64, a64, s64 = mesh_iqu(torch.float64)
	_, _, s32 = mesh_iqu(torch.float32, (m64, a64))
	del m64, a64
	print("mesh emulated IQU roundtrips done at %.1f s" % (time.perf_counter() - h0))
	for lmax in (MESH_LMAX, 750):
		om64, t64 = mesh_step(lmax, torch.float64)
		_, t32 = mesh_step(lmax, torch.float32, om64)
		del om64
		failed += ["mesh step lmax %d %s" % (lmax, dt) for dt, t in (("f64", t64), ("f32", t32)) if not t["ok"]]
	failed += ["mesh IQU %s" % dt for dt, s in (("f64", s64), ("f32", s32)) if not s["ok"]]
	print("mesh emulated steps done at %.1f s" % (time.perf_counter() - h0))
	print("m-block launches of the mesh path (LAUNCHES_MBLOCK, in LAUNCHES_BY_MODE too): %s" % MESH_LAUNCHES)
	mesh_public(failed)
	print("mesh public entry points done at %.1f s" % (time.perf_counter() - h0))
	records = mesh_records(checks)
	missing = [r["name"] for r in records if not r["launches"]]
	if missing: failed.append("m-block kernels not launched by the mesh path: %s" % missing)
	print(card_line())
	print("mesh phase: %.1f s" % (time.perf_counter() - h0))
	if failed: raise RuntimeError("mesh guards failed:\n" + "\n".join(failed))
	return records


IO_LAUNCHES = {}    # launches of the io path's SHTs, by (kernel, mode, dtype)
IO_NEED = 2.2e9     # bytes the io phase's files take at most at once
IO_BOX = np.array([[-10, 10], [10, -10]])   # the box reads' 20 x 20 degrees (dec, ra), ra decreasing
IO_BAND_RES = 0.5    # arcmin: the DR6-sized band's resolution
IO_SHT_SHAPE = (2160, 4320)
IO_LMAX = 2000
IO_NSRC = 10000


def io_dir():
	"""A new temporary directory for the io phase's files, in the first
	candidate with room for IO_NEED bytes; each candidate's free bytes
	printed."""
	import tempfile
	cands = [tempfile.gettempdir(), os.path.join(ROOT, "build")]
	for c in cands:
		os.makedirs(c, exist_ok=True)
		free = shutil.disk_usage(c).free
		print("io: %s has %d bytes free (%.2f GB; needed %.2f GB)" % (c, free, free/1e9, IO_NEED/1e9))
		if free >= 1.25*IO_NEED: return tempfile.mkdtemp(prefix="pixell_io_", dir=c)
	raise RuntimeError("io: no directory with %.2f GB free among %s" % (1.25*IO_NEED/1e9, cands))


def io_timed(fn):
	"""(fn(), wall seconds) with the card synchronized before and after."""
	torch.cuda.synchronize()
	h0 = time.perf_counter()
	out = fn()
	torch.cuda.synchronize()
	return out, time.perf_counter() - h0


def io_rate(label, nbytes, sec, card):
	print("io %s: %d bytes in %.6f s, %.3f GB/s (%s)" % (label, nbytes, sec, nbytes/sec/1e9, card))


def io_same(label, got, want, failed):
	"""got equal to want bit for bit (data, dtype, shape) and, for maps, in wcs."""
	g, w = (x.data if hasattr(x, "wcs") else x for x in (got, want))
	ok = g.dtype == w.dtype and g.shape == w.shape and bool(torch.equal(g, w))
	if hasattr(want, "wcs"): ok = ok and got.wcs.to_header() == want.wcs.to_header()
	print("io %s: equal bit for bit: %s" % (label, ok))
	if not ok: failed.append(label)


def io_band(d, card, failed):
	"""The DR6-sized band: write, whole read, the box reads, and the native
	reader and the copy to the card apart."""
	from pixell_tpu_torch import enmap, utils
	shape, wcs = enmap.band_geometry(np.array([-63, 23])*utils.degree, res=IO_BAND_RES*utils.arcmin)
	gen = torch.Generator(device=DEV)
	gen.manual_seed(23)
	m = enmap.ndmap(torch.randn(tuple(shape), generator=gen, device=DEV, dtype=torch.float32), wcs)
	nb = m.nbytes
	f = os.path.join(d, "band.fits")
	_, sec = io_timed(lambda: enmap.write_map(f, m))
	io_rate("band %s T float32 write_map (FITS)" % (shape,), nb, sec, card)
	for rep in range(2):
		r, sec_whole = io_timed(lambda: enmap.read_map(f, device=DEV))
		io_rate("band read_map whole (FITS, call %d, file warm in the page cache)" % (rep + 1), nb, sec_whole, card)
	io_same("band whole read", r, m, failed)
	del r
	want = m.submap(IO_BOX*utils.degree)
	proxy = enmap.read_map(f, delayed=True, device=DEV)
	if not isinstance(proxy, enmap.ndmap_proxy_fits): failed.append("band delayed read: no proxy")
	bnb = want.nbytes
	for rep in range(2):
		got, sec_box = io_timed(lambda: enmap.submap(proxy, IO_BOX*utils.degree))
		io_rate("band delayed proxy sliced to the %s box (call %d)" % (tuple(want.shape), rep + 1), bnb, sec_box, card)
	io_same("band delayed box read", got, want, failed)
	got, sec_kw = io_timed(lambda: enmap.read_map(f, box=IO_BOX*utils.degree, device=DEV))
	io_rate("band read_map(box=)", bnb, sec_kw, card)
	io_same("band read_map(box=)", got, want, failed)
	ys, xs = enmap.subinds(shape, wcs, IO_BOX*utils.degree, noflip=True).T
	got, sec_sl = io_timed(lambda: proxy[int(ys[0]):int(ys[1]), int(xs[0]):int(xs[1])])
	io_same("band delayed proxy slice", got, want, failed)
	print("io band box read: %d of %d bytes (%.4f %%), %.6f s against the whole read's %.6f s: %.2f %% "
		"of its time (%s)" % (bnb, nb, 100*bnb/nb, sec_box, sec_whole, 100*sec_box/sec_whole, card))
	# the two halves of a whole read: the native reader into pinned memory, the copy to the card
	host = enmap._host_buffer(shape, np.float32, DEV)
	_, sec_nat = io_timed(lambda: proxy.proxy.read_box(0, shape[0], 0, shape[1], out=host.numpy()))
	io_rate("band native reader into pinned memory", nb, sec_nat, card)
	dev = torch.empty_like(m.data)
	h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 5)
	io_rate("band copy from pinned memory to the card (CUDA events, mean of 5)", nb, h2d/1e3, card)
	io_same("band native read", dev, m.data, failed)
	del dev, host, proxy, got, want, m


def io_sht(d, card, failed):
	"""IQU float32 at lmax 2000: alm2map -> disk -> map2alm -> alm2map ->
	disk, with the launches and each SHT stage's ms. Returns (map, alm)."""
	from pixell_tpu_torch import enmap, curvedsky
	shape, wcs = enmap.fullsky_geometry(shape=IO_SHT_SHAPE, variant="fejer1")
	alm = curvedsky.rand_alm(spectrum(IO_LMAX, (0, 2)), lmax=IO_LMAX, seed=5, dtype=torch.complex64, device=DEV)
	m = curvedsky.alm2map(alm, enmap.zeros((3,) + shape, wcs, torch.float32, device=DEV), spin=[0, 2])
	f1, f2 = os.path.join(d, "iqu.fits"), os.path.join(d, "iqu2.fits")
	_, sec = io_timed(lambda: enmap.write_map(f1, m))
	io_rate("IQU %s float32 write_map (FITS)" % (m.shape,), m.nbytes, sec, card)
	r, sec = io_timed(lambda: enmap.read_map(f1, device=DEV))
	io_rate("IQU read_map (FITS)", m.nbytes, sec, card)
	io_same("IQU map read back", r, m, failed)
	ms = {}
	def stage(name, fn):
		e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
		e0.record()
		out = fn()
		e1.record()
		torch.cuda.synchronize()
		ms.setdefault(name, []).append(e0.elapsed_time(e1))
		return out
	anal = lambda: curvedsky.map2alm(r, lmax=IO_LMAX, spin=[0, 2])
	synth = lambda a: curvedsky.alm2map(a, enmap.zeros((3,) + shape, wcs, torch.float32, device=DEV), spin=[0, 2])
	alm2 = hp_drive("io map2alm of the map read", lambda: stage("map2alm", anal),
		hp_entries(torch.float32, [], ["full_analysis"]), IO_LAUNCHES, "io")
	m2 = hp_drive("io alm2map", lambda: stage("alm2map", lambda: synth(alm2)),
		hp_entries(torch.float32, ["sym_synthesis"], []), IO_LAUNCHES, "io")
	stage("map2alm", anal); stage("alm2map", lambda: synth(alm2))
	for name, t in ms.items():
		print("io SHT %s lmax %d IQU float32: %.3f ms (the path's call), %.3f ms (again), CUDA events (%s)"
			% (name, IO_LMAX, t[0], t[1], card))
	ealm = relerr(alm2, alm)
	print("io alm roundtrip through the disk: rel err %.3e (guard 2e-3; %s)" % (ealm, card))
	if not (bool(torch.isfinite(m2.data).all()) and ealm <= 2e-3): failed.append("io alm roundtrip %.3e" % ealm)
	_, sec = io_timed(lambda: enmap.write_map(f2, m2))
	io_rate("IQU alm2map(map2alm) write_map (FITS)", m2.nbytes, sec, card)
	r2, sec = io_timed(lambda: enmap.read_map(f2, device=DEV))
	io_rate("IQU alm2map(map2alm) read_map (FITS)", m2.nbytes, sec, card)
	io_same("IQU map after the SHTs read back", r2, m2, failed)
	return m2, alm2


def io_writers(d, m, alm, card, failed):
	"""The map and its alm through .npy, tilemap and checkpoint; the FITS
	catalogue painted."""
	from pixell_tpu_torch import enmap, tilemap, checkpoint, pointsrcs, utils, bunch
	f = os.path.join(d, "iqu.npy")
	_, sec = io_timed(lambda: enmap.write_map(f, m))
	io_rate("IQU write_map (.npy)", m.nbytes, sec, card)
	r, sec = io_timed(lambda: enmap.read_map(f, wcs=m.wcs, device=DEV))
	io_rate("IQU read_map (.npy)", m.nbytes, sec, card)
	io_same("IQU .npy", r, m, failed)
	tm = tilemap.from_enmap(m, (500, 500))
	f = os.path.join(d, "tiles.fits")
	for rep in range(2):   # the first call imports torch.distributed.tensor (to_enmap's DTensor test)
		_, sec = io_timed(lambda: tilemap.write_map(f, tm))
		io_rate("tilemap (500 x 500 tiles, %d active) write_map (call %d)" % (tm.nactive, rep + 1), m.nbytes, sec,
			card)
	t2, sec = io_timed(lambda: tilemap.read_map(f, (500, 500), device=DEV))
	io_rate("tilemap read_map", m.nbytes, sec, card)
	io_same("tilemap tiles", t2.data, tm.data, failed)
	f = os.path.join(d, "state.pt")
	tree = {"alm": alm, "map": m, "lmax": IO_LMAX}
	nb = m.nbytes + alm.numel()*alm.element_size()
	_, sec = io_timed(lambda: checkpoint.save_pytree(f, tree))
	io_rate("checkpoint.save_pytree of the alm and the map", nb, sec, card)
	back, sec = io_timed(lambda: checkpoint.load_pytree(f, device=DEV))
	io_rate("checkpoint.load_pytree", nb, sec, card)
	io_same("checkpoint alm", back["alm"], alm, failed)
	io_same("checkpoint map", back["map"], m, failed)
	if back["lmax"] != IO_LMAX: failed.append("checkpoint lmax")
	# the catalogue
	poss, amps, prof = c5_catalogue(IO_NSRC)
	cat = bunch.Bunch(ra=poss[1], dec=poss[0], I=amps.astype(np.float64))
	f = os.path.join(d, "cat.fits")
	_, sec = io_timed(lambda: pointsrcs.write_fits_cat(f, cat))
	rc, sec2 = io_timed(lambda: pointsrcs.read(f))
	print("io catalogue of %d sources: write_fits_cat %.6f s, read %.6f s (%s)" % (IO_NSRC, sec, sec2, card))
	# what a FITS catalogue in degrees gives back: the positions through degrees
	gives = bunch.Bunch(ra=cat.ra/utils.degree*utils.degree, dec=cat.dec/utils.degree*utils.degree, I=cat.I)
	for k in ("ra", "dec", "I"):
		if not np.array_equal(rc[k], gives[k]): failed.append("catalogue %s read back" % k)
	paint = lambda c: pointsrcs.sim_objects(m.shape[-2:], m.wcs, np.array([c.dec, c.ra]), c.I.astype(np.float32),
		prof, dtype=np.float32, device=DEV)
	pr, sec = io_timed(lambda: paint(rc))
	io_same("catalogue painted (%.3f s; %s)" % (sec, card), pr, paint(gives), failed)
	pm = paint(cat)
	print("io catalogue painted against the catalogue in memory (positions %.3e rad apart at most): max abs "
		"diff %.3e, rel %.3e (%s)" % (max(np.abs(rc.ra - cat.ra).max(), np.abs(rc.dec - cat.dec).max()),
		float((pr.data - pm.data).abs().max()), relerr(pr.data, pm.data), card))


def io_phase():
	"""The io phase (15. above)."""
	from pixell_tpu_torch import device as pdevice
	h0 = time.perf_counter()
	card = card_line()
	print(card)
	dev = pdevice.get_device()
	print("io: %r memuse before: %d bytes (peak %d; %s)" % (dev, dev.memuse(), dev.memuse("peak"), card))
	IO_LAUNCHES.clear()
	failed = []
	d = io_dir()
	try:
		io_band(d, card, failed)
		print("io band done at %.1f s" % (time.perf_counter() - h0))
		m, alm = io_sht(d, card, failed)
		print("io SHT done at %.1f s" % (time.perf_counter() - h0))
		io_writers(d, m, alm, card, failed)
	finally:
		shutil.rmtree(d)
	print("io: %r memuse after: %d bytes (peak %d; %s)" % (dev, dev.memuse(), dev.memuse("peak"), card))
	print("io launches: %s" % IO_LAUNCHES)
	print(card)
	print("io phase: %.1f s (%s)" % (time.perf_counter() - h0, card))
	if failed: raise RuntimeError("io checks failed: %s" % failed)


# ---------------------------------------------------------------------------
# 16. plot: the install benchmark, the band's colours, Fourier interpolation
# and Bench (scripts, enplot, colorize, utils, bench)
# ---------------------------------------------------------------------------
PLOT_LAUNCHES = {}                   # launches of the plot paths, by (kernel, mode or dtype, dtype or kind)
PLOT_BAND_RES = 0.5                  # arcmin: the DR6-sized band, dec -63 .. +23
PLOT_CUT = (1024, 2048)              # the band's cut held to the same calls on CPU tensors, bit for bit
PLOT_FI_SHAPE = (2160, 4320)         # FourierInterpolator's map
PLOT_FI_NPT = 1_000_000              # and its random positions
PLOT_FI_TOL = 1e-10                  # card against CPU tensors, float64, of the largest value
PLOT_FI_NCPU = 100_000               # the first positions, held to the same call on CPU tensors (each point's
                                     # value is its own; all 10^6 take ~26 s on 8 CPU cores)
PLOT_NREP = 3                        # timed calls (median)
PLOT_TIMING_MS = (2.5407, 3.4572)    # PERF.md section 5's lmax-750 spin-0 f32 row: the timing phase's roundtrip


def plot_events(fn, nrep=PLOT_NREP):
	"""(last result, [ms of each of nrep calls]) with CUDA events around each call."""
	out, ms = None, []
	for _ in range(nrep):
		out = None
		e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
		e0.record()
		out = fn()
		e1.record()
		torch.cuda.synchronize()
		ms.append(e0.elapsed_time(e1))
	return out, ms


def plot_install_benchmark(card, failed):
	"""scripts.benchmark_main on the card, its launches counted (K1, K2 and
	the near-pole passes must launch)."""
	from pixell_tpu_torch import scripts
	elapsed = hp_drive("install benchmark (scripts.benchmark_main: warm-up + %d roundtrips)" % scripts.NROUND,
		scripts.benchmark_main, hp_entries(torch.float32, ["sym_synthesis"], ["sym_analysis"]), PLOT_LAUNCHES,
		"plot")
	nrt = scripts.NROUND + 1
	per = {k: n/nrt for k, n in PLOT_LAUNCHES.items()}
	print("plot install benchmark: %.4f ms a roundtrip (host clock over %d, the card synchronized on either side; "
		"%s); PERF.md section 5's spin-0 lmax-750 f32 row, the timing phase's CUDA events over the same 40 roundtrips: "
		"%.4f-%.4f "
		"ms (the harnesses differ: the host clock around the loop and one warm-up roundtrip here, CUDA events and "
		"two there)" % (
		1e3*elapsed/scripts.NROUND, scripts.NROUND, card, *PLOT_TIMING_MS))
	print("plot install benchmark: launches a roundtrip %s" % per)
	if not elapsed > 0: failed.append("install benchmark time %r" % elapsed)


def plot_band(card, failed):
	"""The DR6-sized band T float32: get_color_range and map_to_color timed
	(CUDA events, median of PLOT_NREP) against the bytes bound (4 B read and
	4 B written a pixel), the memory peak, and a cut of it held bit for bit
	to the same calls on CPU tensors."""
	from pixell_tpu_torch import enmap, enplot, utils
	shape, wcs = enmap.band_geometry(np.array([-63, 23])*utils.degree, res=PLOT_BAND_RES*utils.arcmin)
	gen = torch.Generator(device=DEV)
	gen.manual_seed(26)
	m = enmap.ndmap(torch.randn(tuple(shape), generator=gen, device=DEV, dtype=torch.float32), wcs)
	npix = m.data.numel()
	torch.cuda.synchronize()
	torch.cuda.empty_cache()
	torch.cuda.reset_peak_memory_stats()
	crange = enplot.get_color_range(m)
	_, ms_range = plot_events(lambda: enplot.get_color_range(m))
	enplot.map_to_color(m, crange, "planck")   # warm-up
	rgba, ms_color = plot_events(lambda: enplot.map_to_color(m, crange, "planck"))
	torch.cuda.synchronize()
	peak = torch.cuda.max_memory_allocated()/2**30
	nbytes = npix*(4 + 4)
	bound = 1e3*nbytes/PEAK_BYTES
	ok = tuple(rgba.shape) == (4,) + tuple(shape) and rgba.dtype == torch.uint8 and bool((rgba[3] == 255).all())
	med_r, med_c = float(np.median(ms_range)), float(np.median(ms_color))
	print("plot band %s T float32 (%d pixels): get_color_range %.3f ms (median of %d; min %.3f, max %.3f), range "
		"[%.17g, %.17g]; map_to_color %.3f ms (median of %d; min %.3f, max %.3f) against its bytes bound %.3f ms "
		"(4 B read and 4 B written a pixel, %.3f GB over %.2f TB/s; %.2f %% of it reached); output %s %s, every "
		"pixel opaque: %s; memory peak %.2f GiB (bound %d) (%s)" % (tuple(shape), npix, med_r, len(ms_range),
		min(ms_range), max(ms_range), crange[0], crange[1], med_c, len(ms_color), min(ms_color), max(ms_color), bound,
		nbytes/1e9, PEAK_BYTES/1e12, 100*bound/med_c, tuple(rgba.shape), rgba.dtype, ok, peak, FLAT_MEM_GIB, card))
	if not ok: failed.append("plot band colours of the wrong shape or not opaque")
	if not peak < FLAT_MEM_GIB: failed.append("plot band peak %.2f GiB" % peak)
	# by op, and no copy to the host above 1 MB: the map stays on the card
	flat_profile(lambda: enplot.map_to_color(m, crange, "planck"), 8, "plot band map_to_color")
	# the cut, card against CPU tensors
	r0, c0 = shape[0]//3, shape[1]//2
	cut = m[r0:r0+PLOT_CUT[0], c0:c0+PLOT_CUT[1]]
	cpu = enmap.ndmap(cut.data.cpu(), cut.wcs)
	cr_dev, cr_cpu = enplot.get_color_range(cut), enplot.get_color_range(cpu)
	col_dev, col_cpu = enplot.map_to_color(cut, cr_dev, "planck").cpu(), enplot.map_to_color(cpu, cr_cpu, "planck")
	same = np.array_equal(cr_dev, cr_cpu) and torch.equal(col_dev, col_cpu)
	print("plot band cut %s: colour range and colours on the card equal bit for bit to CPU tensors': %s "
		"(range %r; %d of %d bytes differ)" % (PLOT_CUT, same, cr_dev.tolist(), int((col_dev != col_cpu).sum()),
		col_cpu.numel()))
	if not same: failed.append("plot band cut: card and CPU colours differ")
	return m, crange


def plot_fourier(card, failed):
	"""utils.FourierInterpolator on a float64 map at PLOT_FI_NPT random
	pixel positions: K12 and K10 must launch; its values at the first
	PLOT_FI_NCPU positions against the same call on CPU tensors at those;
	its time (CUDA events, median of PLOT_NREP)."""
	from pixell_tpu_torch import utils
	rng = np.random.default_rng(27)
	ny, nx = PLOT_FI_SHAPE
	data = torch.from_numpy(rng.standard_normal(PLOT_FI_SHAPE)).to(DEV)
	pix = np.array([rng.uniform(0, ny, PLOT_FI_NPT), rng.uniform(0, nx, PLOT_FI_NPT)])
	fi = utils.FourierInterpolator(data)
	v = hp_drive("FourierInterpolator (%d x %d float64, %d positions)" % (ny, nx, PLOT_FI_NPT), lambda: fi(pix),
		["tile_keys", "u2nu_points"], PLOT_LAUNCHES, "plot")
	_, ms = plot_events(lambda: fi(pix))
	h0 = time.perf_counter()
	ref = utils.FourierInterpolator(data.cpu())(pix[:, :PLOT_FI_NCPU])
	sec = time.perf_counter() - h0
	err = relerr(v[:PLOT_FI_NCPU].cpu(), ref)
	ok = tuple(v.shape) == (PLOT_FI_NPT,) and v.dtype == torch.float64 and bool(torch.isfinite(v).all()) \
		and err <= PLOT_FI_TOL
	print("plot FourierInterpolator: %.3f ms a call (median of %d; min %.3f, max %.3f; CUDA events, the positions "
		"copied from the host each call); its first %d values against the same call on CPU tensors at those "
		"positions (%.1f s) rel err %.3e (bound %.0e) %s (%s)" % (float(np.median(ms)), len(ms), min(ms), max(ms),
		PLOT_FI_NCPU, sec, err, PLOT_FI_TOL, "ok" if ok else "FAIL", card))
	if not ok: failed.append("plot FourierInterpolator %.3e" % err)


def plot_bench_timer(m, crange, failed):
	"""bench.Bench().mark around a card call takes no less than the call's
	CUDA-event time."""
	from pixell_tpu_torch import bench, enplot
	b = bench.Bench()
	e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
	with b.mark("map_to_color"):
		e0.record()
		enplot.map_to_color(m, crange, "planck")
		e1.record()
	torch.cuda.synchronize()
	ev = e0.elapsed_time(e1)
	ok = b.n["map_to_color"] == 1 and 1e3*b.t["map_to_color"] >= ev
	print("plot bench: Bench().mark %.3f ms around a call of %.3f ms in CUDA events %s" % (1e3*b.t["map_to_color"],
		ev, "ok" if ok else "FAIL"))
	if not ok: failed.append("plot bench: mark shorter than the call")


def plot_phase():
	"""The plot phase (16. above)."""
	h0 = time.perf_counter()
	card = card_line()
	print(card)
	PLOT_LAUNCHES.clear()
	failed = []
	plot_install_benchmark(card, failed)
	print("plot install benchmark done at %.1f s" % (time.perf_counter() - h0))
	m, crange = plot_band(card, failed)
	print("plot band done at %.1f s" % (time.perf_counter() - h0))
	plot_bench_timer(m, crange, failed)
	del m
	torch.cuda.empty_cache()
	plot_fourier(card, failed)
	print("plot launches in all its paths (each driven with the counts at 0): %s" % PLOT_LAUNCHES)
	print("plot phase: %.1f s (%s)" % (time.perf_counter() - h0, card))
	if failed: raise RuntimeError("plot checks failed: %s" % failed)


# ---------------------------------------------------------------------------
# 17. utils: the helpers that take tensors, on an IQU float64 map on the card
# against the same calls on CPU tensors (pixell_tpu_torch.utils)
# ---------------------------------------------------------------------------
UTILS_SHAPE = (3, 2160, 4320)        # IQU float64 at the lmax-2000 map's size
UTILS_NBIN = 10_000_000              # bincount's and bin_multi's indices
UTILS_NPT = 1_000_000                # point_in_polygon's and poly_edge_dist's points
UTILS_NVERT = 16                     # their polygon's vertices
UTILS_TOL = 1e-12                    # relative, of the largest value: reductions, sorts, linear algebra and
                                     # transcendental functions (neither device's libm rounds them correctly)
UTILS_NREP = 3                       # timed calls (median)
UTILS_CUT = 8                        # the CPU tensors' run: an eighth of the map's rows, of the covariances' rows,
                                     # of the indices and the points (the card runs the whole and the cut)
UTILS_TIMED = ("tofinite", "maskmed", "weighted_median", "bincount", "point_in_polygon")


def utils_inputs():
	"""The phase's inputs, numpy's draws from one seed, as CPU tensors: the
	map, a copy with 0.1 % each of NaN, +inf and -inf, weights, a mask, per
	pixel covariances of a cut of the map, indices, points in a star-shaped
	polygon's box and on the sky around a 16-gon there."""
	rng = np.random.default_rng(28)
	ny, nx = UTILS_SHAPE[1:]
	m = rng.standard_normal(UTILS_SHAPE)
	bad = m.copy()
	flat = bad.reshape(-1)
	for v in (np.nan, np.inf, -np.inf): flat[rng.integers(0, flat.size, flat.size//1000)] = v
	ang = np.linspace(0, 2*np.pi, UTILS_NVERT, endpoint=False)
	rad = 0.3 + 0.15*np.cos(3*ang)
	cut = m[:, ::4, ::8]
	inp = {"m": m, "bad": bad, "ivar": rng.uniform(0.5, 2.0, UTILS_SHAPE), "mask": np.abs(m) < 2,
		"rowmask": rng.random(nx) < 0.5, "ids": rng.integers(0, 100, ny), "A": rng.standard_normal((3, 3)),
		"cov": np.einsum("i...,j...->...ij", cut, cut) + np.eye(3),
		"idx": rng.integers(0, ny*nx, UTILS_NBIN), "w": rng.standard_normal(UTILS_NBIN),
		"pts": rng.uniform(0, 1, (UTILS_NPT, 2)), "poly": np.array([0.5 + rad*np.cos(ang), 0.5 + rad*np.sin(ang)]).T,
		"spts": np.array([rng.uniform(0.7, 1.3, UTILS_NPT), rng.uniform(-0.55, -0.05, UTILS_NPT)]).T,
		"sky": np.array([1.0 + 0.2*np.cos(ang), -0.3 + 0.15*np.sin(ang)]).T}
	return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}


def utils_cut(inp):
	"""The inputs cut for the CPU tensors' run: the first UTILS_CUT-th of
	the map's rows (and of their ids), of the covariances' rows, of the
	indices and weights and of the points."""
	ny, n = UTILS_SHAPE[1]//UTILS_CUT, UTILS_NBIN//UTILS_CUT
	out = dict(inp)
	for k in ("m", "bad", "ivar", "mask"): out[k] = inp[k][:, :ny].contiguous()
	out["ids"] = inp["ids"][:ny].contiguous()
	out["cov"] = inp["cov"][:inp["cov"].shape[0]//UTILS_CUT].contiguous()
	for k in ("idx", "w"): out[k] = inp[k][:n].contiguous()
	for k in ("pts", "spts"): out[k] = inp[k][:UTILS_NPT//UTILS_CUT].contiguous()
	return out


def utils_cases():
	"""(label, fn(inputs) -> result, exact) for every helper of utils that
	takes tensors; the exact ones are held bit for bit."""
	from pixell_tpu_torch import utils as u
	ny, nx = UTILS_SHAPE[1:]
	def flatview(i):
		arr = i["m"].clone()
		with u.flatview(arr, axes=[0]) as f: f *= 2
		return arr
	def eigsort(i):
		E, V = u.eigsort(i["cov"])
		return E, torch.einsum("...ij,...j,...kj->...ik", V, E, V)   # V up to sign
	return [
		("tofinite", lambda i: u.tofinite(i["bad"]), True),
		("remove_nan", lambda i: u.remove_nan(i["bad"].clone()), True),
		("without_nan", lambda i: u.without_nan(i["bad"]), True),
		("rescale", lambda i: u.rescale(i["m"]), True),
		("minmax", lambda i: u.minmax(i["m"], axis=-1), True),
		("medmean2", lambda i: u.medmean2(i["m"], axis=-1), False),
		("maskmed", lambda i: u.maskmed(i["m"], i["mask"]), False),
		("weighted_quantile", lambda i: u.weighted_quantile(i["m"], i["ivar"], 0.3), False),
		("weighted_median", lambda i: u.weighted_median(i["m"], i["ivar"]), False),
		("partial_flatten", lambda i: u.partial_flatten(i["m"], [0]), True),
		("partial_expand", lambda i: u.partial_expand(u.partial_flatten(i["m"], [0]), tuple(i["m"].shape), [0]), True),
		("flatview", flatview, True),
		("moveaxes", lambda i: u.moveaxes(i["m"], [0, 1], [2, 0]), True),
		("addaxes", lambda i: u.addaxes(i["m"], [0, 2]), True),
		("delaxes", lambda i: u.delaxes(i["m"][:, None, :1], [1, 2]), True),
		("atleast_3d", lambda i: u.atleast_3d(i["m"][0]), True),
		("atleast_Nd", lambda i: u.atleast_Nd(i["m"], 5), True),
		("to_Nd", lambda i: u.to_Nd(i["m"], 2), True),
		("preflat", lambda i: u.preflat(i["m"], 2), True),
		("postflat", lambda i: u.postflat(i["m"], 2), True),
		("blockify", lambda i: u.blockify(i["m"], 16), True),
		("block_mean_filter", lambda i: u.block_mean_filter(i["m"], 16), False),
		("slice_downgrade", lambda i: u.slice_downgrade(i["m"], slice(0, None, 4)), False),
		("resize_array", lambda i: u.resize_array(i["m"], [3, 2000, 4500]), True),
		("unmask", lambda i: u.unmask(i["m"][..., i["rowmask"]], i["rowmask"], axis=2), True),
		("pixwin_1d", lambda i: u.pixwin_1d(0.25*i["m"][0], order=1), False),
		("triangle_wave", lambda i: u.triangle_wave(i["m"], period=0.7), True),
		("gnfw", lambda i: u.gnfw(i["m"].abs() + 0.01, 0.497, 1.0, 4.65, -0.3), False),
		("vec_angdist", lambda i: u.vec_angdist(i["m"], torch.roll(i["m"], 1, -1)), False),
		("ang2chord", lambda i: u.ang2chord(i["m"]), False),
		("chord2ang", lambda i: u.chord2ang(i["m"].clamp(-2, 2)), False),
		("matvec", lambda i: u.matvec(i["A"], torch.movedim(i["m"], 0, -1)), False),
		("cov2corr", lambda i: u.cov2corr(i["cov"]), False),
		("corr2cov", lambda i: u.corr2cov(*u.cov2corr(i["cov"])), False),
		("eigsort", eigsort, False),
		("nodiag", lambda i: u.nodiag(i["cov"]), True),
		("deslope", lambda i: u.deslope(i["m"], w=4), False),
		("bincount", lambda i: u.bincount(i["idx"], minlength=ny*nx), True),
		("bincount (weights, 2 rows)", lambda i: u.bincount(i["idx"].reshape(2, -1), i["w"].reshape(2, -1)), False),
		("bin_multi", lambda i: u.bin_multi(torch.stack([i["idx"]//nx, i["idx"] % nx]), (ny, nx)), True),
		("sum_by_id", lambda i: u.sum_by_id(i["m"][0], i["ids"]), False),
		("argmax", lambda i: u.argmax(i["m"]), True),
		("argmin", lambda i: u.argmin(i["m"]), True),
		("find_first", lambda i: u.find_first(i["m"] > 3.5), True),
		("find_last", lambda i: u.find_last(i["m"] > 3.5, axis=1), True),
		("point_in_polygon", lambda i: u.point_in_polygon(i["pts"], i["poly"]), True),
		("poly_edge_dist", lambda i: u.poly_edge_dist(i["spts"], i["sky"]), False),
	]


def utils_held(dev, cpu, exact):
	"""(ok, err): the card's result (CUDA tensors, leaf by leaf) against the
	CPU tensors' of the same call, equal bit for bit (NaN where NaN; err the
	entries that differ) or within UTILS_TOL of the largest value (err the
	relative error; non-finite entries in the same places)."""
	if isinstance(cpu, (tuple, list)):
		res = [utils_held(d, c, exact) for d, c in zip(dev, cpu)]
		return len(dev) == len(cpu) and all(r[0] for r in res), max(r[1] for r in res)
	if not (isinstance(dev, torch.Tensor) and dev.is_cuda): return False, float("inf")
	d = dev.cpu()
	if d.shape != cpu.shape or d.dtype != cpu.dtype: return False, float("inf")
	if exact or not d.is_floating_point():
		if torch.equal(d, cpu): return True, 0.0
		same = d == cpu
		if d.is_floating_point(): same |= (d != d) & (cpu != cpu)
		n = int((~same).sum())
		return n == 0, float(n)
	# finite: x - x == 0 (torch's CPU isfinite is several times slower)
	fin = (cpu - cpu) == 0
	if not torch.equal(fin, (d - d) == 0): return False, float("inf")
	if d.numel() == 0: return True, 0.0
	scale = float(torch.where(fin, cpu, 0.0).abs().max())
	err = float(torch.where(fin, d - cpu, 0.0).abs().max())/(scale or 1.0)
	return err <= UTILS_TOL, err


def utils_cuda(x):
	"""Whether every leaf of a result is a CUDA tensor."""
	if isinstance(x, (tuple, list)): return all(utils_cuda(v) for v in x)
	return isinstance(x, torch.Tensor) and x.is_cuda


def utils_phase():
	"""The utils phase (17. above)."""
	h0 = time.perf_counter()
	card = card_line()
	print(card)
	full = utils_inputs()
	cpu = utils_cut(full)
	dev = {k: v.to(DEV) for k, v in full.items()}
	dev_cut = utils_cut(dev)
	del full
	print("utils inputs made and copied to the card at %.1f s" % (time.perf_counter() - h0))
	failed, t_dev, t_cpu, cases = [], 0.0, 0.0, utils_cases()
	for label, fn, exact in cases:
		t0 = time.perf_counter()
		whole = fn(dev)
		torch.cuda.synchronize()
		t1 = time.perf_counter()
		on_cuda = utils_cuda(whole)
		del whole
		got = fn(dev_cut)
		t2 = time.perf_counter()
		want = fn(cpu)
		t3 = time.perf_counter()
		t_dev, t_cpu = t_dev + t2 - t0, t_cpu + t3 - t2
		ok, err = utils_held(got, want, exact)
		ok = ok and on_cuda
		print("utils %s: the whole inputs on the card %s (%.1f ms, first call, host clock); the cut on the card "
			"against CPU tensors %s: %s (CPU %.1f ms)" % (label, "gave CUDA tensors" if on_cuda else "NOT on the card",
			1e3*(t1 - t0), ("bit for bit, %d entries differ" % err) if exact else
			("rel err %.3e (bound %.0e)" % (err, UTILS_TOL)), "ok" if ok else "FAIL", 1e3*(t3 - t2)))
		if not ok: failed.append(label)
		del got, want
	fns = dict((label, fn) for label, fn, _ in cases)
	for label in UTILS_TIMED:
		_, ms = plot_events(lambda: fns[label](dev), UTILS_NREP)
		print("utils timing %s: %.3f ms (median of %d; min %.3f, max %.3f; CUDA events) (%s)" % (label,
			float(np.median(ms)), len(ms), min(ms), max(ms), card))
	del dev, dev_cut
	torch.cuda.empty_cache()
	print("utils phase: %.1f s (the card's calls %.1f s, the CPU tensors' on the cut %.1f s; %d helpers' calls "
		"held; %s)" % (time.perf_counter() - h0, t_dev, t_cpu, len(cases), card))
	if failed: raise RuntimeError("utils checks failed: %s" % failed)


PHASES = ("k9", "kernels", "lstop", "slice", "adjoint", "blocked", "timing", "general", "flat", "interp",
	"healpix", "lensing", "config5", "analysis", "mesh", "io", "plot", "utils")   # utils runs first
EXTRA_PHASES = ("variants", "blkprobe")   # run only when named


def main():
	ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
	ap.add_argument("--phases", default=",".join(PHASES),
		help="comma-separated choice of %s (default: all but %s)" % (", ".join(PHASES + EXTRA_PHASES),
		", ".join(EXTRA_PHASES)))
	ap.add_argument("--parent", default=None, help="a directory holding a parent tree's legendre.cu, "
		"blockleg.cu and / or nufft.cu: the kernels phase times the float64 kernels it launched beside the "
		"float64 rows, the variants phase holds its float32 kernels against this tree's, the blocked phase "
		"times its blk_synthesis_kernel beside this tree's, the general phase its unbinned K10 / K11")
	args = ap.parse_args()
	phases = args.phases.split(",")
	if not set(phases) <= set(PHASES + EXTRA_PHASES): ap.error("unknown phase in %s" % phases)
	if not torch.cuda.is_available():
		print("chip_smoke: no CUDA device", file=sys.stderr)
		return 2
	sys.path.insert(0, ROOT)
	from concurrent.futures import ThreadPoolExecutor
	from pixell_tpu_torch.ops import sht_cuda, _build
	from pixell_tpu_torch import fits_io
	t_start = time.perf_counter()
	print(card_line())
	print("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
		sys.version.split()[0]))
	torch.backends.cuda.matmul.allow_tf32 = False
	torch.backends.cudnn.allow_tf32 = False
	parent = blk_parent = nufft_parent = None
	if not set(phases) <= {"flat", "interp", "utils"}:   # these paths run no hand-written kernel
		h0 = time.perf_counter()
		with ThreadPoolExecutor(3) as ex:   # the parent's build and the native FITS reader beside this tree's
			lib = ex.submit(sht_cuda.library)
			parent = None if args.parent is None else ex.submit(parent_library, args.parent)
			fits = ex.submit(fits_io._get_core) if "io" in phases else None
			lib.result()
			parent = parent and parent.result()
			fits = fits and fits.result()
		print("kernel build + load%s: %.1f s%s" % (" (and the native FITS reader's)" if fits else "",
			time.perf_counter() - h0, "" if parent is None else
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
		dist_build_check(build_rows)
	records, kernel_records, f64_records, launches, launches64, an_recs, mesh_recs = [], {}, {}, {}, {}, [], []
	blk_records, lstop_records, gen_records = {}, {}, []
	if "utils" in phases:   # first: it needs no kernel, and a fault in it shows before the long phases
		utils_phase()
		print("phase utils done at %.1f s" % (time.perf_counter() - t_start))
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
	if "flat" in phases:
		flat_phase()
		print("phase flat done at %.1f s" % (time.perf_counter() - t_start))
	if "interp" in phases:
		interp_phase()
		print("phase interp done at %.1f s" % (time.perf_counter() - t_start))
	if "healpix" in phases:
		healpix_phase()
		print("phase healpix done at %.1f s" % (time.perf_counter() - t_start))
	if "lensing" in phases:
		lensing_phase()
		print("phase lensing done at %.1f s" % (time.perf_counter() - t_start))
	if "config5" in phases:
		config5_phase()
		print("phase config5 done at %.1f s" % (time.perf_counter() - t_start))
	if "analysis" in phases:
		an_recs = analysis_phase()
		print("phase analysis done at %.1f s" % (time.perf_counter() - t_start))
	if "mesh" in phases:
		mesh_recs = mesh_phase()
		print("phase mesh done at %.1f s" % (time.perf_counter() - t_start))
	if "io" in phases:
		io_phase()
		print("phase io done at %.1f s" % (time.perf_counter() - t_start))
	if "plot" in phases:
		plot_phase()
		print("phase plot done at %.1f s" % (time.perf_counter() - t_start))
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
		+ [r[0] for r in lstop_records.values()] + list(blk_records.values()) + gen_records + records + an_recs \
		+ mesh_recs
	for rec in records:   # the launches of each record's kernel in the healpix and lensing paths
		rec["healpix_launches"] = hp_count(rec)
		rec["lensing_launches"] = hp_count(rec, LENS_LAUNCHES)
		rec["config5_launches"] = hp_count(rec, C5_LAUNCHES)
		rec["io_launches"] = hp_count(rec, IO_LAUNCHES)
		rec["plot_launches"] = hp_count(rec, PLOT_LAUNCHES)
	print(card_line())
	print(json.dumps({"kernels": records}))
	print(json.dumps({"ok": True, "device": {"platform": "gpu",
		"kind": torch.cuda.get_device_name(0), "count": 1}}))
	return 0


if __name__ == "__main__":
	sys.exit(main())
