"""The float64 K1-K4 (pixell_tpu_torch.ops.sht_cuda: sym_synthesis,
full_synthesis, sym_analysis and full_analysis, whose float64 launches run
csrc/legendre.cu's bulk_synthesis_kernel<double> and
bulk_analysis_kernel<double> through the entry points of BULK_F64) on the
CPU.

- The dispatch: with the launches recorded instead of run, every float64
  launch of the four wrappers, in all five modes, both forms and column
  chunks 4 + 2, goes to its float64 entry with the arguments it takes, and
  never with stop degrees or a state handoff, which float64 launches
  refuse; the engine's float64 dispatch takes no near-pole pass and no
  stop table.
- The shapes of chip_smoke.py's float64 rows are those a float64 lmax-750
  spin 0 and spin [0, 3] roundtrip launches (recorded on the CPU), and its
  expected launch counts (f64_launches) are those roundtrips'; at lmax 750
  they hold every float64 instantiation; their operation counts and the
  bound with the accumulation on the FP64 tensor cores are the function's;
  --parent launches a parent's float64 bulk entries, or an older parent's
  synthesis_kernel / analysis_kernel entries.
- The function: kernel_synthesis / kernel_analysis in float64, whose CPU
  path runs the kernels' plain versions, against pixell_tpu's scans within
  1e-10 of the largest reference value, on a south-symmetric ring set and
  on one that is not.
The CUDA kernels run only on a GPU; chip_smoke.py holds them against the
plain versions tested here (python3 chip_smoke.py --phases kernels).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu.ops import sht_core as jcore
from pixell_tpu_torch import sht, curvedsky, enmap
from pixell_tpu_torch.ops import sht_cuda, sht_core
from test_torch_analysis_bulk import launches, rings, spin_of, ncol   # noqa: F401 (fixture)

MODES = ["scalar", "deriv", "spin1", "spin2", "wigner"]
LMAX, MMAX = 40, 29  # 30 m rows: not a multiple of the m tile


@pytest.mark.parametrize("mode", MODES)
def test_f64_launches_reach_f64_entry(mode, launches):
	"""Each wrapper in float64: one launch of its float64 entry per column
	chunk (6 columns: 4 + 2) with (C, input, 7 tables, output, nl, nm, nt,
	[nplanes,] s, no stops, no state, stream); a float64 launch with stop
	degrees or a state handoff raises before anything is launched."""
	s, nf = spin_of(mode), sht_core.NFUN[mode]
	theta = rings(150)   # three ring tiles
	g = sht_cuda.geom(theta, MMAX, torch.float64, "cpu", s)
	nt = len(theta)
	inputs = {"full_synthesis": torch.zeros((LMAX + 1, MMAX + 1, 6), dtype=torch.float64),
		"full_analysis": torch.zeros((nf, 6, MMAX + 1, nt), dtype=torch.float64)}
	if mode != "wigner":
		inputs["sym_synthesis"] = inputs["full_synthesis"]
		inputs["sym_analysis"] = torch.zeros((nf, 6, 2, MMAX + 1, nt), dtype=torch.float64)
	for name, x in inputs.items():
		launches.clear()
		out = getattr(sht_cuda, name)(x, g, LMAX, mode)
		assert out.dtype == torch.float64 and out.shape[1 if "synthesis" in name else 2] == 6
		assert [c[:3] for c in launches] == [(sht_cuda.BULK_F64[name], mode, True)]*2
		syn = name.endswith("synthesis")
		for (_, _, _, args), C in zip(launches, (4, 2)):
			assert len(args) == (18 if syn else 19) and args[0] == C and args[-1] == 0
			dims = (LMAX + 1, MMAX + 1, nt) + (() if syn else (sht_cuda._planes(3),)) + (s or 0,)
			assert args[10:10 + len(dims)] == dims
			assert args[-3:-1] == (0, 0)   # no stop degrees, no state
	lstop = torch.full((-(-(MMAX + 1)//sht_cuda.TILE_M), 3), LMAX + 1, dtype=torch.int32)
	launches.clear()
	for name in ("full_synthesis", "full_analysis"):
		with pytest.raises(ValueError):
			getattr(sht_cuda, name)(inputs[name], g, LMAX, mode, lstop)
		with pytest.raises(ValueError):
			getattr(sht_cuda, name)(inputs[name], g, LMAX, mode, lstop, True)
	if mode != "wigner":
		with pytest.raises(ValueError):
			sht_cuda.sym_synthesis(inputs["sym_synthesis"], g, LMAX, mode, lstop)
	assert not launches


@pytest.mark.parametrize("mode", ["scalar", "spin2", "wigner"])
def test_f64_dispatch_takes_no_polar_pass(mode, launches, monkeypatch):
	"""kernel_synthesis / kernel_analysis in float64: the whole ring set,
	near-pole rings included, through K1/K2 where it is south-symmetric (K3/K4
	in wigner mode) and K3/K4 where it is not, analysis in TCHUNK chunks;
	no near-pole pass and no stop table."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	monkeypatch.setattr(sht_cuda, "TCHUNK", 64)
	s, nf, C = spin_of(mode), sht_core.NFUN[mode], ncol(mode)
	lmax = 60
	asym = np.sort(np.concatenate([rings(100, seed=3), [0.02, np.pi - 0.03]]))
	for theta, sym in ((sht.ring_theta("F1", 2*lmax + 2), True), (asym, False)):
		nn, ns = sht_cuda.polar_counts(theta, lmax)
		assert nn and ns
		half = sym and mode != "wigner"
		launches.clear()
		A = torch.zeros((lmax + 1, lmax + 1, C), dtype=torch.float64)
		sht_cuda.kernel_synthesis(A, theta, lmax, lmax, mode, torch.float64, s)
		F = torch.zeros((nf, C, lmax + 1, len(theta)), dtype=torch.float64)
		sht_cuda.kernel_analysis(F, theta, lmax, lmax, mode, torch.float64, s)
		nchunks = 1 if half else -(-len(theta)//64)
		want = [sht_cuda.BULK_F64["sym_synthesis" if half else "full_synthesis"]] \
			+ [sht_cuda.BULK_F64["sym_analysis" if half else "full_analysis"]]*nchunks
		assert [c[0] for c in launches] == want
		assert all(c[1:3] == (mode, True) and c[3][-3:-1] == (0, 0) for c in launches)
		assert launches[0][3][12] == ((len(theta) + 1)//2 if half else len(theta))


def record_roundtrip(lmax, shape, spin, launches):
	"""[(entry, mode, nl, nm, nt)] of a float64 roundtrip (alm2map, map2alm,
	alm2map) of the spins spin on a full-sky Fejer-1 map, the launches
	recorded instead of run."""
	gshape, wcs = enmap.fullsky_geometry(shape=shape, variant="fejer1")
	ps = np.zeros((3, 3, lmax + 1)) if len(spin) > 1 else np.ones(lmax + 1)
	if len(spin) > 1: ps[0, 0], ps[1, 1], ps[2, 2] = 1, 1, 1
	alm = curvedsky.rand_alm(ps, lmax=lmax, seed=1, dtype=torch.complex128, device="cpu")
	mshape = gshape if alm.ndim == 1 else (alm.shape[0],) + gshape
	launches.clear()
	m = curvedsky.alm2map(alm, enmap.zeros(mshape, wcs, torch.float64, device="cpu"), spin=list(spin))
	a = curvedsky.map2alm(m, lmax=lmax, spin=list(spin))
	curvedsky.alm2map(a, enmap.zeros(mshape, wcs, torch.float64, device="cpu"), spin=list(spin))
	return [(name, mode) + tuple(args[10:13]) for name, mode, _, args in launches]


@pytest.mark.parametrize("spin", [(0,), (0, 3)])
def test_f64_rows_are_the_roundtrips_shapes(spin, launches):
	"""chip_smoke.py's float64 rows at lmax 750 (f64_row_cases) in the modes
	of a float64 roundtrip of the spins spin on 900 x 1800 are launches of
	that roundtrip, entry, mode, degrees, m rows and rings; and the
	roundtrip launches what chip_smoke.f64_launches expects of it."""
	import chip_smoke
	lmax = 750
	got = record_roundtrip(lmax, (900, 1800), spin, launches)
	count = {}
	for name, mode, *_ in got: count[(name, mode, "float64")] = count.get((name, mode, "float64"), 0) + 1
	assert count == chip_smoke.f64_launches(lmax, 900, spin)
	modes = {"scalar"} | ({"wigner"} if 3 in spin else set())
	rows = [(sht_cuda.BULK_F64[name], mode, lmax + 1, lmax + 1, len(theta))
		for name, lm, theta, _, timed in chip_smoke.f64_row_cases() if lm == lmax
		for mode in timed if mode in modes]
	assert len(rows) == (4 if 3 in spin else 2)
	for row in rows: assert row in got, row
	for mode in modes:
		assert chip_smoke.f64_path("sym_synthesis" if mode == "scalar" else "full_synthesis", lmax, mode) \
			== "f64 %s lmax %d roundtrip" % ("spin 0" if mode == "scalar" else "spin [0, 3]", lmax)


def test_f64_lmax2000_rows_follow_the_dispatch():
	"""At lmax 2000 the 4032 upsampled rings are more than 2 SYM_MAX_NH: the
	float64 map2alm runs K4 in TCHUNK chunks, the first of them the K4 row's
	rings, and the map's 2160 rings take K1 on their northern half."""
	import chip_smoke
	from pixell_tpu_torch import fft
	nt_up = fft.fft_len(2*2000 + 3, direction="above")
	assert nt_up > 2*sht_cuda.SYM_MAX_NH and sht_cuda.detect_sym(sht.ring_theta("F1", nt_up)) is None
	want = chip_smoke.f64_launches(2000, 2160, (0, 2))
	assert want == {(sht_cuda.BULK_F64[k], m, "float64"): n for k, n in (("sym_synthesis", 2),
		("full_analysis", -(-nt_up//sht_cuda.TCHUNK))) for m in ("scalar", "spin2")}
	rows = {(name, lmax): len(theta) for name, lmax, theta, _, _ in chip_smoke.f64_row_cases()}
	assert rows[("full_analysis", 2000)] == sht_cuda.TCHUNK and rows[("full_synthesis", 2000)] == nt_up
	assert rows[("sym_synthesis", 2000)] == 1080


def test_f64_rows_hold_every_instantiation():
	"""chip_smoke.py's float64 rows at lmax 750 hold every float64
	instantiation that its build check counts (F64_INSTANTIATIONS): each
	wrapper in each mode it has, at 2 and at 4 coefficient columns."""
	import chip_smoke
	held = {(name, mode, C) for name, lmax, _, pairs, _ in chip_smoke.f64_row_cases() if lmax == 750
		for mode, C in pairs}
	want = {(name, mode, C) for name in sht_cuda.BULK_F64 for mode in MODES for C in (2, 4)
		if not (mode == "wigner" and name.startswith("sym"))}
	assert held == want and len(held) == chip_smoke.F64_INSTANTIATIONS


@pytest.mark.parametrize("mode", MODES)
def test_f64_bounds_count_the_function(mode):
	"""chip_smoke.py's operation count is the function's: synthesis and its
	transpose, analysis, count the same operations in either form; the
	bound with the accumulation on the FP64 tensor cores (dmma_bound) prices
	it at PEAK_DMMA and the rest at the FP64 peak."""
	import chip_smoke
	C, nt = chip_smoke.ncoef(mode), 300
	ops = {name: chip_smoke.kernel_ops(name, mode, LMAX, MMAX, nt, C) for name in sht_cuda.BULK_F64}
	assert len(set(ops.values())) == 1
	other, acc = chip_smoke.kernel_ops("full_analysis", mode, LMAX, MMAX, nt, C, split=True)
	assert other + acc == ops["full_analysis"] and acc == 2*C*sht_core.NFUN[mode]*other//(
		chip_smoke.STEP_OPS + chip_smoke.MODE_OPS[mode])
	nbytes = chip_smoke.kernel_bytes("full_analysis", mode, LMAX, MMAX, nt, C, 8)
	dm = chip_smoke.dmma_bound("full_analysis", mode, LMAX, MMAX, nt, C, nbytes)
	assert dm == pytest.approx(1e3*max(other/34e12 + acc/67e12, nbytes/3.35e12), rel=1e-12)
	assert dm <= chip_smoke.bound(ops["full_analysis"], nbytes, torch.float64)[0]


@pytest.mark.parametrize("newer", [False, True])
def test_parent_library_routes_f64_launches(newer, monkeypatch):
	"""chip_smoke.py --parent: a parent library with the float64 bulk
	entries has them launched and their kernel timed; an older one, the
	synthesis_kernel / analysis_kernel entries named after the wrappers."""
	import re
	import chip_smoke
	from pixell_tpu_torch.ops import _build
	f64 = tuple(sht_cuda.BULK_F64.values()) if newer else tuple(sht_cuda.BULK_F64)
	names = {"pt_%s_%s" % (e, m) for e in tuple(sht_cuda.BULK_KERNELS.values()) + f64 for m in MODES}
	calls = []

	class Lib:
		def __getattr__(self, attr):
			if attr not in names: raise AttributeError(attr)
			fn = lambda *args: calls.append(attr) or 0
			setattr(self, attr, fn)
			return fn

	monkeypatch.setattr(_build, "load", lambda csrc: Lib())
	lib = chip_smoke.parent_library("parent_csrc")
	with chip_smoke.parent_kernels(lib):
		sht_cuda._launch(sht_cuda.BULK_F64["sym_analysis"], "spin2", -1, True)
		sht_cuda._launch(sht_cuda.BULK_KERNELS["full_synthesis"], "wigner", -1, False)
	assert calls == ["pt_%s_spin2" % ("sym_bulk_analysis_f64" if newer else "sym_analysis"),
		"pt_full_bulk_synthesis_wigner"]
	pattern = chip_smoke.parent_pattern("sym_analysis", lib)
	assert bool(re.search(pattern, "void bulk_analysis_kernel_f64<2, true, 2>(")) == newer
	assert bool(re.search(pattern, "void analysis_kernel<double, 2, true>(")) != newer


def reference(x, theta, lmax, mmax, mode, synth):
	xj = jnp.asarray(x)
	if mode == "wigner":
		fn = jcore.wigner_synthesis_scan if synth else jcore.wigner_analysis_scan
		return np.asarray(fn(xj, theta, lmax, mmax, 3))
	fn = jcore.synthesis_scan if synth else jcore.analysis_scan
	return np.asarray(fn(xj, theta, lmax, mmax, mode=mode, dtype=np.float64))


@pytest.mark.parametrize("mode", MODES)
def test_f64_kernel_scans_match_reference(mode):
	"""kernel_synthesis and kernel_analysis in float64 against the reference
	scans on a south-symmetric ring set (K1/K2; K3/K4 in wigner mode) and on
	one that is not (K3/K4), near-pole rings included, within 1e-10 of the
	largest reference value."""
	nf, C = sht_core.NFUN[mode], ncol(mode)
	rng = np.random.default_rng(30 + MODES.index(mode))
	for theta in (sht.ring_theta("F1", 64), rings(61, seed=5)):
		A = rng.standard_normal((LMAX + 1, MMAX + 1, C))
		F = rng.standard_normal((nf, C, MMAX + 1, len(theta)))
		for synth, x in ((True, A), (False, F)):
			fn = sht_cuda.kernel_synthesis if synth else sht_cuda.kernel_analysis
			out = fn(torch.from_numpy(x), theta, LMAX, MMAX, mode, torch.float64, spin_of(mode))
			ref = reference(x, theta, LMAX, MMAX, mode, synth)
			assert out.shape == ref.shape and out.dtype == torch.float64
			assert np.abs(out.numpy() - ref).max() <= 1e-10*np.abs(ref).max(), (mode, synth)
