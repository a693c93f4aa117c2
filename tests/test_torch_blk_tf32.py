"""The 3xTF32 products of the block-Legendre analysis kernel
(pixell_tpu_torch/csrc/blockleg.cu blk_analysis_kernel, K8c/K8d) on the CPU.

- The precision plan. TF32 keeps 10 mantissa bits; the kernel splits each
  operand of its three products -- the ring -> node contraction, the
  per-degree node sums and the chain-end product of the state step -- into
  hi = tf32(x) and lo = tf32(x - hi) and sums lo*hi + hi*lo + hi*hi with
  float32 accumulators. Emulated here in torch (round to nearest, ties to
  even) on the plain twin's block loop (ops/sht_core.py blk_analysis), at
  the shapes of tests/test_torch_blocked.py's blk_case, the 3xTF32 result
  stays within twice the float32 twin's error against the float64 twin in
  every mode. One TF32 pass is printed beside it, not asserted: it misses
  the split's 3e-5 bound by an order of magnitude.
- W's split, built once per ring set on the host (sht_cuda.tf32_split, in
  blk_tables): bit-identical to the emulation, hi + lo within 2^-22 of W.
- The dispatch, with the launches recorded instead of run (as
  tests/test_torch_analysis_bulk.py does): blk_analysis passes the entry's
  arguments, the split table among them, in every mode at C = 4 and 2; the
  blocked analysis reaches it under sht.blocked(); a split table of the
  wrong dtype, device, shape or layout, or none, raises before a launch.
- chip_smoke.py's probed copy of the kernel (--phases blkprobe) applies to
  the committed source.
The CUDA kernel runs only on a GPU; python3 chip_smoke.py --phases blocked
holds it against the float64 twin there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu_torch import sht
from pixell_tpu_torch.ops import sht_cuda, sht_core

MODES = [("scalar", 2), ("deriv", 2), ("spin1", 2), ("spin2", 4)]
LB = sht_cuda.BLK_LB


def tf32(x):
	"""x (float32) rounded to TF32: 10 mantissa bits, to nearest, ties to even."""
	u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
	u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
	return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def split(x):
	hi = tf32(x)
	return hi, tf32(x - hi)


def product(eq, a, b, passes):
	"""einsum in float32 of TF32 operands: passes 3 sums lo*hi + hi*lo +
	hi*hi, passes 1 takes hi*hi alone (TF32 products are exact in float32;
	the sums round)."""
	ah, al = split(a)
	bh, bl = split(b)
	if passes == 1: return torch.einsum(eq, ah, bh)
	return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def tf32_analysis(F, state, tab, g, lmax, mode, passes):
	"""sht_core.blk_analysis with its three products in TF32: the kernel's
	order of operations (node sums per stream, then weighted by the stream
	coefficients)."""
	run = sht_core._BlkRun(state, tab, g, lmax + 1, mode)
	run.to_rings = lambda L: product("...mnj,njt->...mnt", L, run.W, passes)   # the chain-end product
	nfun, C = sht_core.NFUN[mode], F.shape[1]
	Fp = run.tiles(F)
	out = torch.zeros((run.nlb*LB, run.nmp, C))
	for il in range(run.first, run.nlb):
		act = (run.start <= il)[..., 0]
		G = torch.stack(sht_core.blk_fields(mode, Fp[0], Fp[nfun - 1], *run.rings), 1)
		currf, prevf = run.factors()
		Wc = product("csmnt,njt->csmnj", currf*G, run.W, passes)
		Wp = product("csmnt,njt->csmnj", prevf*G, run.W, passes)
		for l, gAc, gAp, gBc, gBp in run.chains(il):
			tot = 0
			for s, prevfam in enumerate(run.fam):
				Q = product("mnj,cmnj->cmn", gAp if prevfam else gAc, Wc[:, s], passes) \
					+ product("mnj,cmnj->cmn", gBp if prevfam else gBc, Wp[:, s], passes)
				tot = tot + run.cs[s, l][:, None]*Q
			out[l] = torch.where(act, tot, torch.zeros(())).sum(-1).T
		run.step_state(il)
	return out[:run.nl, :run.nm]


def blk_case(mode, C, seed):
	"""tests/test_torch_blocked.py's blk_case, its tables built by the port:
	three 112-degree blocks, 16 m rows, two ring tiles of 128 mid-latitude
	rings starting at blocks 1 and 2, a random O(1) state at levels 0 and
	-1."""
	lmax, mmax, tb = 3*LB - 1, 15, 128
	theta = np.linspace(0.9, 2.2, 2*tb)
	rng = np.random.default_rng(seed)
	F = rng.standard_normal((sht_core.NFUN[mode], C, mmax + 1, 2*tb)).astype(np.float32)
	state = np.zeros((3, mmax + 1, 2*tb), np.float32)
	state[:2] = rng.standard_normal((2, mmax + 1, 2*tb))
	state[2] = -rng.integers(0, 2, (mmax + 1, 2*tb))
	ctv, W = sht_cuda.blk_node_tables(theta, tb)
	start = torch.tensor([[1, 2]], dtype=torch.int32)
	tab = sht_core.BlkTables(start, torch.from_numpy(ctv.astype(np.float32)),
		torch.from_numpy(W.astype(np.float32)), 16, tb)
	tab64 = sht_core.BlkTables(start, torch.from_numpy(ctv), torch.from_numpy(W), 16, tb)
	return lmax, theta, mmax, torch.from_numpy(F), torch.from_numpy(state), tab, tab64


def relerr(x, ref):
	return float((x.double() - ref).abs().max()/ref.abs().max())


@pytest.mark.parametrize("mode,C", MODES)
def test_3xtf32_precision_plan(mode, C):
	lmax, theta, mmax, F, state, tab, tab64 = blk_case(mode, C, 12)
	g32 = sht_cuda.geom(theta, mmax, torch.float32, "cpu")
	g64 = sht_cuda.geom(theta, mmax, torch.float64, "cpu")
	ref = sht_core.blk_analysis(F.double(), state.double(), tab64, g64, lmax, mode)
	e32 = relerr(sht_core.blk_analysis(F, state, tab, g32, lmax, mode), ref)
	e3 = relerr(tf32_analysis(F, state, tab, g32, lmax, mode, 3), ref)
	e1 = relerr(tf32_analysis(F, state, tab, g32, lmax, mode, 1), ref)
	print("%s: against the float64 twin, float32 %.3e, 3xTF32 %.3e, one TF32 pass %.3e" % (
		mode, e32, e3, e1))
	assert ref.abs().max() > 1 and 0 < e32 < 2e-5
	assert e3 <= 2*e32


def test_tf32_emulation():
	"""The emulated rounding: 10 mantissa bits kept, ties to even, signs
	and exact TF32 numbers unchanged."""
	x = torch.tensor([1 + 2**-10, 1 + 2**-11, 1 + 3*2**-11, -(1 + 2**-11), 1 + 2**-11 + 2**-20, 0.0,
		3.0, -2.5], dtype=torch.float32)
	want = torch.tensor([1 + 2**-10, 1.0, 1 + 2**-9, -1.0, 1 + 2**-10, 0.0, 3.0, -2.5])
	assert torch.equal(tf32(x), want)
	r = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
	hi, lo = split(r)
	assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
	assert float(((hi.double() + lo.double() - r.double())/r.double()).abs().max()) <= 2.0**-22
	assert float(((hi.double() - r.double())/r.double()).abs().max()) <= 2.0**-11


# ---------------------------------------------------------------------------
# W's split and the dispatch
# ---------------------------------------------------------------------------
def rings(lmax):
	"""Fejer-1 rings without the last three (not south-symmetric), as the
	split test of tests/test_torch_blocked.py."""
	return np.asarray(sht.ring_theta("F1", 2*lmax + 2), np.float64)[:-3]


LMAX = 335


def test_w_split_built_once():
	theta = rings(LMAX)
	tab, _ = sht_cuda.blk_tables(theta, LMAX, LMAX, "cpu")
	hits = sht_cuda._blk_cached.cache_info().hits
	again, _ = sht_cuda.blk_tables(theta.copy(), LMAX, LMAX, "cpu")
	assert again is tab and again.Wtf32 is tab.Wtf32
	assert sht_cuda._blk_cached.cache_info().hits == hits + 1
	ntb = -(-len(theta)//sht_cuda.BLK_TILE_T)
	assert tuple(tab.Wtf32.shape) == (2, ntb, sht_cuda.BLK_JP, sht_cuda.BLK_TILE_T)
	assert tab.Wtf32.dtype == torch.float32 and tab.Wtf32.is_contiguous()
	hi, lo = split(tab.W)
	assert torch.equal(tab.Wtf32[0], hi) and torch.equal(tab.Wtf32[1], lo)
	W64 = torch.from_numpy(sht_cuda.blk_node_tables(theta, sht_cuda.BLK_TILE_T)[1])
	err = (tab.Wtf32.double().sum(0) - W64).abs()
	assert float(err.max()) <= 2.0**-22*float(W64.abs().max())
	assert not (tab.Wtf32[:, -1, :, len(theta) % sht_cuda.BLK_TILE_T:] != 0).any()   # padding rings
	assert np.array_equal(sht_cuda.tf32_split(np.float32([1 + 2**-11, 1 + 3*2**-11])),
		np.float32([[1, 1 + 2**-9], [2**-11, -2**-11]]))


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


def case(mode, ncol):
	theta = rings(LMAX)
	nm, nt = LMAX + 1, len(theta)
	tab, _ = sht_cuda.blk_tables(theta, LMAX, LMAX, "cpu")
	g = sht_cuda.geom(theta, LMAX, torch.float32, "cpu")
	F = torch.zeros((sht_core.NFUN[mode], ncol, nm, nt))
	return theta, tab, g, F, torch.zeros((3, nm, nt))


@pytest.mark.parametrize("mode,C", MODES)
def test_blk_analysis_launch_arguments(mode, C, launches):
	"""(C, F, a/b, streams, state, start, nodes, W's split, cos theta, ring
	rows, partial planes, nl, nm, nt, planes, stream), one launch per column
	chunk: 6 columns launch C = 4, then 2."""
	theta, tab, g, F, state = case(mode, 6)
	nm, nt = g.nm, g.nt
	out = sht_cuda.blk_analysis(F, state, tab, g, LMAX, mode)
	assert out.shape == (LMAX + 1, nm, 6) and out.dtype == torch.float32
	assert [c[:3] for c in launches] == [("blk_analysis", mode, False)]*2
	ntb = -(-nt//sht_cuda.BLK_TILE_T)
	for (_, _, _, args), ncol in zip(launches, (4, 2)):
		assert len(args) == 16 and args[0] == ncol
		assert args[4:8] == (state.data_ptr(), tab.start.data_ptr(), tab.ctv.data_ptr(),
			tab.Wtf32.data_ptr())
		assert args[8:10] == (g.ct.data_ptr(), g.rows.data_ptr())
		assert args[11:] == (LMAX + 1, nm, nt, sht_cuda._planes(ntb), 0)
	# a block of C columns alone
	launches.clear()
	sht_cuda.blk_analysis(F[:, :C].contiguous(), state, tab, g, LMAX, mode)
	assert [c[3][0] for c in launches] == [C]


@pytest.mark.parametrize("mode", ["scalar", "spin2"])
def test_blocked_analysis_reaches_the_kernel(mode, launches, monkeypatch):
	"""Under sht.blocked(), with BLK_MINL lowered to a CPU size as
	tests/test_torch_blocked.py does: K4's float32 bulk hands its state over
	and blk_analysis launches with W's split; outside, no block kernel."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	theta, tab, g, F, state = case(mode, dict(MODES)[mode])
	with sht.blocked():
		sht_cuda._anal_rings(F, theta, LMAX, LMAX, mode, torch.float32)
	assert [c[0] for c in launches] == ["full_bulk_analysis", "blk_analysis"]
	assert launches[1][3][7] == tab.Wtf32.data_ptr() and launches[0][3][16] != 0
	launches.clear()
	sht_cuda._anal_rings(F, theta, LMAX, LMAX, mode, torch.float32)
	assert [c[0] for c in launches] == ["full_bulk_analysis"]


@pytest.mark.parametrize("bad", ["none", "dtype", "device", "shape", "layout"])
def test_blk_analysis_rejects_split_tables(bad, launches):
	theta, tab, g, F, state = case("scalar", 2)
	W2 = tab.Wtf32
	W2 = {"none": None, "dtype": W2.double(), "device": W2.to("meta"), "shape": W2[:, :, :-1].contiguous(),
		"layout": W2.transpose(2, 3).contiguous().transpose(2, 3)}[bad]
	badtab = sht_core.BlkTables(tab.start, tab.ctv, tab.W, tab.tile_m, tab.tile_t, W2)
	with pytest.raises(ValueError):
		sht_cuda.blk_analysis(F, state, badtab, g, LMAX, "scalar")
	assert not launches
	sht_cuda.blk_analysis(F, state, tab, g, LMAX, "scalar")
	assert len(launches) == 1


def test_probe_build_from_edited_copy(tmp_path, monkeypatch):
	"""chip_smoke.py's blkprobe phase: each probe of BLK_PROBES finds its one
	place in csrc/blockleg.cu, and the probed copy builds into a directory
	of its own, from its own sources."""
	import chip_smoke
	from pixell_tpu_torch.ops import _build
	monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path/"build"/"pixell_tpu_torch")
	d = chip_smoke.blk_probe_sources()
	text = (d/"blockleg.cu").read_text()
	assert text.count("PT_PROBE(") == len(chip_smoke.BLK_PROBES) + 1 and "pt_blk_probe" in text
	assert sorted(p.name for p in d.glob("*.cu")) == sorted(p.name for p in _build._sources())
	assert _build.build_dir(d) != _build.build_dir()
	assert all(c[-1].startswith(str(d)) for _, c in _build.compile_commands(_build.build_dir(d), "nvcc", d))
