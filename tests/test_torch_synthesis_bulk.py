"""The float32 bulk of K1/K3 (pixell_tpu_torch.ops.sht_cuda: sym_synthesis and
full_synthesis, which launch csrc/legendre.cu's bulk_synthesis_kernel, its
float instantiations in float32 and its double ones in float64) on the
CPU.

- The dispatch: with the launches recorded instead of run, every float32
  launch of sym_synthesis / full_synthesis, in every mode, with and without
  stop degrees and with the state handoff, and on the paths that reach them
  (kernel_synthesis at both ring-set kinds, sht.blocked()), goes to the bulk
  kernel's entry point with the arguments it takes, the dead-tile table
  where the ring set has dead tiles; float64 launches go to its float64
  entry (tests/test_torch_f64_bulk.py tests those further).
- The half-sky form's even/odd split: the north plane is E + O and the
  mirror plane PSIGN[f] (-1)^m (E - O), E and O the sums over even and odd
  l, which the kernel accumulates apart.
- The half-sky form's dead-tile table (its northern rings' tiles): within
  1e-9 of the sums without it, and against pixell_tpu's scan on the whole
  ring set within 2e-5 (float32, the bound of tests/test_pallas.py for the
  float32 kernels) and 1e-10 (float64) of the largest reference value.
The CUDA kernel runs only on a GPU; chip_smoke.py holds it against the plain
versions tested here (python3 chip_smoke.py --phases kernels,lstop).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu import sht as jsht
from pixell_tpu.ops import sht_core as jcore
from pixell_tpu_torch import sht
from pixell_tpu_torch.ops import sht_cuda, sht_core
from test_torch_analysis_bulk import launches, rings, spin_of, ncol   # noqa: F401 (fixture)

MODES = ["scalar", "deriv", "spin1", "spin2", "wigner"]
LEGENDRE = MODES[:4]
LMAX, MMAX = 40, 29  # 30 m rows: not a multiple of the m tile


@pytest.mark.parametrize("mode", MODES)
def test_f32_launches_reach_bulk_kernel(mode, launches):
	"""sym_synthesis and full_synthesis in float32: the bulk kernel's entry
	point with (C, A, 7 tables, out, nl, nm, nt, s, stops, state, stream),
	one launch per column chunk (6 columns: 4 + 2), the stop table and the
	state where given (the state on the first chunk only); in float64 its
	float64 entry with the same arguments."""
	s, nf = spin_of(mode), sht_core.NFUN[mode]
	theta = rings(150)   # three ring tiles
	g32 = sht_cuda.geom(theta, MMAX, torch.float32, "cpu", s)
	g64 = sht_cuda.geom(theta, MMAX, torch.float64, "cpu", s)
	A = torch.zeros((LMAX + 1, MMAX + 1, 6))
	lstop = torch.full((-(-(MMAX + 1)//sht_cuda.TILE_M), 3), 16, dtype=torch.int32)
	variants = [("full_synthesis", None, False), ("full_synthesis", lstop, False)]
	if mode != "wigner":
		variants += [("full_synthesis", lstop, True), ("sym_synthesis", None, False),
			("sym_synthesis", lstop, False)]
	for name, stops, dump in variants:
		extra = (stops,) + ((dump,) if name == "full_synthesis" else ())
		launches.clear()
		out = getattr(sht_cuda, name)(A, g32, LMAX, mode, *extra)
		if dump:
			out, state = out
			assert state.shape == (3, MMAX + 1, len(theta))
		planes = (2,) if name == "sym_synthesis" else ()
		assert out.shape == (nf, 6) + planes + (MMAX + 1, len(theta)) and out.dtype == torch.float32
		assert [c[:3] for c in launches] == [(sht_cuda.BULK_KERNELS[name], mode, False)]*2
		for (_, _, _, args), C in zip(launches, (4, 2)):
			assert len(args) == 18 and args[0] == C and args[17] == 0   # the whole transform: m0 = 0
			assert args[10:14] == (LMAX + 1, MMAX + 1, len(theta), s or 0)
			assert (args[14] != 0) == (stops is not None)
		assert (launches[0][3][15] != 0) == dump and launches[1][3][15] == 0
		launches.clear()
		getattr(sht_cuda, name)(A.double(), g64, LMAX, mode)
		assert [c[:3] for c in launches] == [(sht_cuda.BULK_F64[name], mode, True)]*2
		assert [(len(c[3]), c[3][0], c[3][-1]) for c in launches] == [(18, 4, 0), (18, 2, 0)]


def dead_rings(lmax, seed):
	"""A ring set that is not south-symmetric, with a ring near each pole and
	a tile of 64 bulk rings close enough to the north pole that its high m
	rows are dead at lmax."""
	rng = np.random.default_rng(seed)
	return np.sort(np.concatenate([np.linspace(0.08, 0.4, 70),
		rng.uniform(0.5, np.pi - 0.3, 60), [0.02, np.pi - 0.03]]))


@pytest.mark.parametrize("mode", ["scalar", "spin2", "wigner"])
def test_dispatch_paths_reach_bulk_kernel(mode, launches, monkeypatch):
	"""kernel_synthesis in float32: on a south-symmetric ring set the bulk
	rings take the half-sky bulk kernel (in wigner mode the full one) with
	the dead-tile table of its northern rings, on one that is not the full
	bulk kernel with the table of its rings; the near-pole rings
	polar_synthesis. No other float32 kernel is launched."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	s, C = spin_of(mode), ncol(mode)
	lmax = 60
	for theta, sym in ((sht.ring_theta("F1", 600), True), (dead_rings(lmax, 3), False)):
		nn, ns = sht_cuda.polar_counts(theta, lmax)
		assert nn and ns and (sht_cuda.detect_sym(theta) is not None) == sym
		launches.clear()
		A = torch.zeros((lmax + 1, lmax + 1, C))
		G = sht_cuda.kernel_synthesis(A, theta, lmax, lmax, mode, torch.float32, s)
		assert G.shape == (sht_core.NFUN[mode], C, lmax + 1, len(theta))
		half = sym and mode != "wigner"
		bulk = "sym_bulk_synthesis" if half else "full_bulk_synthesis"
		assert [c[:3] for c in launches] == [(bulk, mode, False), ("polar_synthesis", mode, True)]
		kernel_rings = theta[:sht_cuda.detect_sym(theta)] if half else theta
		dead = sht_cuda.dead_stops(kernel_rings, lmax, lmax, s or 0, "cpu")
		assert dead is not None and launches[0][3][14] == dead.data_ptr()


@pytest.mark.parametrize("mode", LEGENDRE)
def test_blocked_prefix_reaches_bulk_kernel(mode, launches, monkeypatch):
	"""Under sht.blocked() the prefix launches of blocked_synthesis are the
	full bulk kernel with the split's stop degrees and the state handed
	over, followed by the block kernel."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	lmax = 335
	theta = np.asarray(jsht.ring_theta("F1", 2*lmax + 2), np.float64)[:-3]
	A = torch.zeros((lmax + 1, lmax + 1, ncol(mode)))
	with sht.blocked():
		sht_cuda.blocked_synthesis(A, theta, lmax, lmax, mode)
	assert [c[0] for c in launches] == ["full_bulk_synthesis", "blk_synthesis"]
	args = launches[0][3]
	assert args[14] != 0 and args[15] != 0


@pytest.mark.parametrize("mode", LEGENDRE)
def test_even_odd_identity(mode):
	"""The half-sky synthesis from its even-l and odd-l sums: with E and O
	the full synthesis of A masked to even and to odd l on the northern
	rings, the north plane is E + O and the mirror plane
	PSIGN[f] (-1)^m (E - O) (float64, 1e-12 of the largest value)."""
	rng = np.random.default_rng(LEGENDRE.index(mode))
	north = sht.ring_theta("F1", 64)[:32]
	g = sht_cuda.geom(north, MMAX, torch.float64, "cpu")
	A = torch.from_numpy(rng.standard_normal((LMAX + 1, MMAX + 1, 4)))
	even = (torch.arange(LMAX + 1) % 2 == 0).to(A.dtype)[:, None, None]
	E = sht_core.synthesis(A*even, g, LMAX, mode)
	O = sht_core.synthesis(A*(1 - even), g, LMAX, mode)
	sign = torch.tensor(sht_core.PSIGN[mode], dtype=A.dtype)[:, None, None, None] \
		* (1 - 2*(torch.arange(MMAX + 1) % 2)).to(A.dtype)[:, None]
	pair = sht_cuda._sym_synthesis_plain(A, g, LMAX, mode)
	scale = float(pair.abs().max())
	assert float((pair[:, :, 0] - (E + O)).abs().max()) <= 1e-12*scale
	assert float((pair[:, :, 1] - sign*(E - O)).abs().max()) <= 1e-12*scale


def north_rings():
	"""Northern rings of a south-symmetric set whose first 64-ring tile lies
	close enough to the pole that its high m rows are dead at lmax 48. They
	start at 0.1 rad: nearer the pole the float32 recurrence itself, with
	the table or without, is off by more than 2e-5 in the spin modes (1e-4
	at 0.02 rad), which is why the float32 path runs its near-pole rings in
	float64."""
	return np.concatenate([np.linspace(0.1, 0.2, 64), np.linspace(0.3, 1.5, 40)])


@pytest.mark.parametrize("mode", LEGENDRE)
def test_sym_dead_table_matches_reference(mode):
	"""sym_synthesis with the dead-tile table of its northern rings: within
	1e-9 of the same without it (float64, lmax 48), and both planes against
	pixell_tpu's scan on the whole ring set (north and mirrored) within 2e-5
	(float32) and 1e-10 (float64)."""
	lmax = mmax = 48
	north = north_rings()
	full = np.concatenate([north, np.pi - north[::-1]])
	nh = len(north)
	stops = sht_cuda.dead_stops(north, lmax, mmax, 0, "cpu")
	assert stops is not None and bool((stops == 0).any())
	rng = np.random.default_rng(20 + LEGENDRE.index(mode))
	A = rng.standard_normal((lmax + 1, mmax + 1, 4))
	ref = np.asarray(jcore.synthesis_scan(jnp.asarray(A), full, lmax, mmax, mode=mode,
		dtype=np.float64))
	ref_pair = np.stack([ref[..., :nh], ref[..., ::-1][..., :nh]], 2)
	scale = np.abs(ref).max()
	g64 = sht_cuda.geom(north, mmax, torch.float64, "cpu")
	skip = sht_cuda.sym_synthesis(torch.from_numpy(A), g64, lmax, mode, stops)
	every = sht_cuda.sym_synthesis(torch.from_numpy(A), g64, lmax, mode)
	assert float((skip - every).abs().max()) <= 1e-9*scale
	for dt, tol in ((torch.float64, 1e-10), (torch.float32, 2e-5)):
		G = sht_cuda.sym_synthesis(torch.from_numpy(A).to(dt), sht_cuda.geom(north, mmax, dt, "cpu"),
			lmax, mode, stops)
		assert G.shape == ref_pair.shape and G.dtype == dt
		assert np.abs(G.double().numpy() - ref_pair).max() <= tol*scale, (mode, dt)


def test_sym_stop_table_checked(launches):
	"""On the card, sym_synthesis takes a stop table of its northern rings'
	tiles only: contiguous int32 [m blocks, ring tiles], in float32 (a
	float64 launch takes none)."""
	north = north_rings()
	g = sht_cuda.geom(north, 20, torch.float32, "cpu")
	A = torch.zeros((21, 21, 2), dtype=torch.float32)
	for bad in (torch.zeros((6, 2), dtype=torch.int64), torch.zeros((5, 2), dtype=torch.int32)):
		with pytest.raises(ValueError):
			sht_cuda.sym_synthesis(A, g, 20, "scalar", bad)
	with pytest.raises(ValueError):
		sht_cuda.sym_synthesis(A.double(), sht_cuda.geom(north, 20, torch.float64, "cpu"), 20, "scalar",
			torch.zeros((6, 2), dtype=torch.int32))
	sht_cuda.sym_synthesis(A, g, 20, "scalar", torch.zeros((6, 2), dtype=torch.int32))
	assert [c[0] for c in launches] == ["sym_bulk_synthesis"]
