"""The float32 bulk of K2/K4 (pixell_tpu_torch.ops.sht_cuda: sym_analysis and
full_analysis, which launch csrc/legendre.cu's bulk_analysis_kernel, its
float instantiations in float32 and its double ones in float64) on the
CPU.

- The dispatch: with the launches recorded instead of run, every float32
  launch of sym_analysis / full_analysis, in every mode, with and without
  stop degrees and with the state handoff, and on the paths that reach them
  (kernel_analysis at both ring-set kinds, sht.blocked()), goes to the bulk
  kernel's entry point with the arguments it takes; float64 launches go to
  its float64 entry (tests/test_torch_f64_bulk.py tests those further).
- The function: kernel_analysis, whose CPU path runs the kernels' plain
  versions, against pixell_tpu's scan on a ring set whose bulk is
  south-symmetric (K2) and on one that is not (K4), within 2e-5 (float32,
  the bound of tests/test_pallas.py for the float32 kernels) and 1e-10
  (float64) of the largest reference value.
- The stop table the kernel reads per (4 m rows x 64 rings) block against
  the reference's _dead_table at the same tiles.
The CUDA kernel runs only on a GPU; chip_smoke.py holds it against the plain
versions tested here (python3 chip_smoke.py --phases kernels,lstop).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import sht as jsht
from pixell_tpu.ops import sht_core as jcore, sht_pallas as jpallas
from pixell_tpu_torch import sht
from pixell_tpu_torch.ops import sht_cuda, sht_core

MODES = ["scalar", "deriv", "spin1", "spin2", "wigner"]
S = 3               # the wigner mode's spin
LMAX, MMAX = 40, 29  # 30 m rows: not a multiple of the m tile


def spin_of(mode):
	return S if mode == "wigner" else None


def ncol(mode):
	return 4 if mode in ("spin2", "wigner") else 2


@pytest.fixture
def launches(monkeypatch):
	"""Record every kernel launch as (entry, mode, f64, arguments) instead of
	running it: CPU tensors take the card's path, and the outputs stay the
	zeros the wrappers allocate."""
	calls = []
	monkeypatch.setattr(sht_cuda, "_on_card", lambda x: True)
	monkeypatch.setattr(sht_cuda, "_stream", lambda x: 0)
	monkeypatch.setattr(sht_cuda, "_launch",
		lambda name, mode, device, f64, *args: calls.append((name, mode, f64, args)))
	return calls


def rings(nt, seed=0):
	return np.sort(np.random.default_rng(seed).uniform(0.3, np.pi - 0.3, nt))


@pytest.mark.parametrize("mode", MODES)
def test_f32_launches_reach_bulk_kernel(mode, launches):
	"""sym_analysis and full_analysis in float32: the bulk kernel's entry
	point with (C, F, 7 tables, part, nl, nm, nt, nplanes, s, stops, state,
	stream), one launch per column chunk (6 columns: 4 + 2), the stop table
	and the state where given (the state on the first chunk only); in
	float64 its float64 entry with the same arguments."""
	s, nf = spin_of(mode), sht_core.NFUN[mode]
	theta = rings(150)   # three ring tiles
	g32 = sht_cuda.geom(theta, MMAX, torch.float32, "cpu", s)
	g64 = sht_cuda.geom(theta, MMAX, torch.float64, "cpu", s)
	F = torch.zeros((nf, 6, MMAX + 1, len(theta)))
	lstop = torch.full((-(-(MMAX + 1)//sht_cuda.TILE_M), 3), 16, dtype=torch.int32)
	variants = [("full_analysis", None, False), ("full_analysis", lstop, False)]
	if mode != "wigner":
		variants += [("full_analysis", lstop, True), ("sym_analysis", None, False)]
	for name, stops, dump in variants:
		x = F if name == "full_analysis" else torch.zeros((nf, 6, 2, MMAX + 1, len(theta)))
		extra = () if name == "sym_analysis" else (stops, dump)
		launches.clear()
		out = getattr(sht_cuda, name)(x, g32, LMAX, mode, *extra)
		if dump:
			out, state = out
			assert state.shape == (3, MMAX + 1, len(theta))
		assert out.shape == (LMAX + 1, MMAX + 1, 6) and out.dtype == torch.float32
		assert [c[:3] for c in launches] == [(sht_cuda.BULK_KERNELS[name], mode, False)]*2
		for (_, _, _, args), C in zip(launches, (4, 2)):
			assert len(args) == 19 and args[0] == C and args[18] == 0   # the whole transform: m0 = 0
			assert args[10:15] == (LMAX + 1, MMAX + 1, len(theta), sht_cuda._planes(3), s or 0)
			assert (args[15] != 0) == (stops is not None)
		assert (launches[0][3][16] != 0) == dump and launches[1][3][16] == 0
		launches.clear()
		getattr(sht_cuda, name)(x.double(), g64, LMAX, mode)
		assert [c[:3] for c in launches] == [(sht_cuda.BULK_F64[name], mode, True)]*2
		assert [(len(c[3]), c[3][0], c[3][-1]) for c in launches] == [(19, 4, 0), (19, 2, 0)]


def test_bulk_variants_build_from_edited_copies(tmp_path, monkeypatch):
	"""chip_smoke.py's variants phase: each edit of BULK_VARIANTS applies
	to csrc/legendre.cu, and the edited copy builds into a directory of its
	own, from its own sources."""
	import chip_smoke
	from pixell_tpu_torch.ops import _build
	monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path/"build"/"pixell_tpu_torch")
	dirs = {_build.build_dir()}
	for label, (old, new) in chip_smoke.BULK_VARIANTS.items():
		d = chip_smoke.variant_sources(label, old, new)
		src = (d/"legendre.cu").read_text()
		assert src.count(new) >= 1 and old not in src.replace(new, "")
		assert sorted(p.name for p in d.glob("*.cu")) == sorted(p.name for p in _build._sources())
		cmds = _build.compile_commands(_build.build_dir(d), "nvcc", d)
		assert all(c[-1].startswith(str(d)) for _, c in cmds)
		dirs.add(_build.build_dir(d))
	assert len(dirs) == 1 + len(chip_smoke.BULK_VARIANTS)


@pytest.mark.parametrize("mode", ["scalar", "spin2", "wigner"])
def test_dispatch_paths_reach_bulk_kernel(mode, launches, monkeypatch):
	"""kernel_analysis in float32: on a south-symmetric ring set the bulk
	rings take the half-sky bulk kernel (in wigner mode the full one), on
	one that is not the full bulk kernel in TCHUNK chunks; the near-pole
	rings polar_analysis. No float64 entry of K2/K4 is launched."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	monkeypatch.setattr(sht_cuda, "TCHUNK", 64)
	s, nf, C = spin_of(mode), sht_core.NFUN[mode], ncol(mode)
	lmax = 60
	asym = np.sort(np.concatenate([rings(100, seed=3), [0.02, np.pi - 0.03]]))
	for theta, sym in ((sht.ring_theta("F1", 2*lmax + 2), True), (asym, False)):
		launches.clear()
		F = torch.zeros((nf, C, lmax + 1, len(theta)))
		sht_cuda.kernel_analysis(F, theta, lmax, lmax, mode, torch.float32, s)
		nn, ns = sht_cuda.polar_counts(theta, lmax)
		assert nn and ns and (sht_cuda.detect_sym(theta[nn:len(theta) - ns]) is not None) == sym
		bulk = "sym_bulk_analysis" if sym and mode != "wigner" else "full_bulk_analysis"
		nb = 1 if bulk.startswith("sym") else -(-(len(theta) - nn - ns)//64)
		assert [c[0] for c in launches] == [bulk]*nb + ["polar_analysis"]
		assert all(c[2] is False for c in launches[:nb])


@pytest.mark.parametrize("mode", ["scalar", "deriv", "spin1", "spin2"])
def test_blocked_prefix_reaches_bulk_kernel(mode, launches, monkeypatch):
	"""Under sht.blocked() the prefix launches of blocked_analysis are the
	full bulk kernel with the split's stop degrees and the state handed
	over, followed by the block kernel."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	lmax = 335
	theta = np.asarray(jsht.ring_theta("F1", 2*lmax + 2), np.float64)[:-3]
	nf, C = sht_core.NFUN[mode], ncol(mode)
	F = torch.zeros((nf, C, lmax + 1, len(theta)))
	with sht.blocked():
		sht_cuda.blocked_analysis(F, theta, lmax, lmax, mode)
	assert [c[0] for c in launches] == ["full_bulk_analysis", "blk_analysis"]
	args = launches[0][3]
	assert args[15] != 0 and args[16] != 0


def reference(F, theta, lmax, mmax, mode, dtype):
	if mode == "wigner":
		return np.asarray(jcore.wigner_analysis_scan(jnp.asarray(F), theta, lmax, mmax, S))
	return np.asarray(jcore.analysis_scan(jnp.asarray(F), theta, lmax, mmax, mode=mode,
		dtype=dtype))


@pytest.mark.parametrize("mode", MODES)
def test_kernel_analysis_matches_reference(mode):
	"""kernel_analysis (the plain versions of K2/K4 and of the near-pole
	pass) on a south-symmetric ring set and on one that is not, both with
	near-pole rings at lmax 40, against the reference scan in float64 and
	float32."""
	nf, C = sht_core.NFUN[mode], ncol(mode)
	sym_set = sht.ring_theta("F1", 64)
	asym_set = rings(61, seed=5)
	assert sht_cuda.detect_sym(sym_set) == 32 and sht_cuda.detect_sym(asym_set) is None
	rng = np.random.default_rng(MODES.index(mode))
	for theta in (sym_set, asym_set):
		F = rng.standard_normal((nf, C, MMAX + 1, len(theta)))
		ref = reference(F, theta, LMAX, MMAX, mode, np.float64)
		for dt, tol in ((torch.float64, 1e-10), (torch.float32, 2e-5)):
			a = sht_cuda.kernel_analysis(torch.from_numpy(F), theta, LMAX, MMAX, mode, dt,
				spin_of(mode))
			assert a.shape == ref.shape and a.dtype == dt
			assert np.abs(a.double().numpy() - ref).max() <= tol*np.abs(ref).max(), (mode, dt)


@pytest.mark.parametrize("lmax,nt", [(300, 333), (2000, 2048)])
def test_stop_table_matches_reference(lmax, nt):
	"""dead_stops, the table the bulk kernel reads per block of TILE_M m
	rows by TILE_T rings, marks the reference's dead tiles at that tiling
	(_dead_table with tb = TILE_T and its MB m rows, spread to TILE_M) and
	runs every other block to the end."""
	theta = rings(nt, seed=7)
	theta[:64] = np.linspace(0.01, 0.3, 64)   # a ring tile near a pole, where rows die
	theta = np.sort(theta)
	stops = sht_cuda.dead_stops(theta, lmax, lmax, 0, "cpu")
	assert stops is not None and set(np.unique(stops.numpy())) == {0, lmax + 1}
	ref = np.asarray(jpallas._dead_table(theta, lmax, lmax, sht_cuda.TILE_T))
	mb = jpallas.MB
	assert mb % sht_cuda.TILE_M == 0
	# a reference m tile of MB rows is dead where its first row is past the
	# horizon: every MB/TILE_M-th of the port's tiles starts at the same row
	ours = stops.numpy() == 0
	assert ref.any() and np.array_equal(ours[::mb//sht_cuda.TILE_M], ref)
	assert np.array_equal(ours, sht_cuda.dead_table(theta, lmax, lmax, sht_cuda.TILE_M,
		sht_cuda.TILE_T))
