"""The 3xTF32 node -> ring product of the block-Legendre synthesis kernel
(pixell_tpu_torch/csrc/blockleg.cu blk_synthesis_kernel, K8a/K8b) on the
CPU.

- The precision plan. The kernel takes its product D = W^T B (rings x
  nodes by nodes x fold rows and chain ends) on the tensor cores with both
  operands split into TF32 hi and lo, summing lo*hi + hi*lo + hi*hi in
  float32 accumulators: W split in registers, the folds split by the
  producer as it stores them. Emulated here in torch (round to nearest,
  ties to even, as tests/test_torch_blk_tf32.py does) on the plain twin's
  block loop (ops/sht_core.py blk_synthesis), at that file's blk_case
  shapes, it stays within twice the float32 twin's error against the
  float64 twin in every mode at C = 2 and 4. One TF32 pass is printed
  beside it (-s), not asserted.
- W in the kernel's fragment order (sht_cuda.blk_w_fragments, BlkTables.
  Wfrag), built once per ring set: bit-equal to W permuted, and its split
  bit-equal to tf32_split(W) in the same order.
- The dispatch, with the launches recorded instead of run (as
  tests/test_torch_blk_tf32.py does for blk_analysis): blk_synthesis passes
  the entry's arguments, the fragment table among them, in every mode at
  C = 4 and 2; the blocked synthesis reaches it under sht.blocked(); a
  fragment table of the wrong dtype, device, shape or layout, or none,
  raises before a launch.
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
from test_torch_blk_tf32 import LMAX, case, launches, product, relerr, rings, split  # noqa: F401 (fixture)

SYN_MODES = [(m, c) for m in ("scalar", "deriv", "spin1", "spin2") for c in (2, 4)]
LB = sht_cuda.BLK_LB


def synth_case(mode, C, seed):
	"""tests/test_torch_blk_tf32.py's blk_case for the synthesis: three
	112-degree blocks, 16 m rows, two ring tiles of 128 mid-latitude rings
	starting at blocks 1 and 2, random alm and a random O(1) state at
	levels 0 and -1."""
	lmax, mmax, tb = 3*LB - 1, 15, 128
	theta = np.linspace(0.9, 2.2, 2*tb)
	rng = np.random.default_rng(seed)
	A = rng.standard_normal((lmax + 1, mmax + 1, C)).astype(np.float32)
	state = np.zeros((3, mmax + 1, 2*tb), np.float32)
	state[:2] = rng.standard_normal((2, mmax + 1, 2*tb))
	state[2] = -rng.integers(0, 2, (mmax + 1, 2*tb))
	ctv, W = sht_cuda.blk_node_tables(theta, tb)
	start = torch.tensor([[1, 2]], dtype=torch.int32)
	tab = sht_core.BlkTables(start, torch.from_numpy(ctv.astype(np.float32)),
		torch.from_numpy(W.astype(np.float32)), 16, tb)
	tab64 = sht_core.BlkTables(start, torch.from_numpy(ctv), torch.from_numpy(W), 16, tb)
	return lmax, theta, mmax, torch.from_numpy(A), torch.from_numpy(state), tab, tab64


def tf32_synthesis(A, state, tab, g, lmax, mode, passes):
	"""sht_core.blk_synthesis with its node -> ring products (the folds and
	the chain ends of the state step) in TF32."""
	run = sht_core._BlkRun(state, tab, g, lmax + 1, mode)
	run.to_rings = lambda L: product("...mnj,njt->...mnt", L, run.W, passes)
	nfun, NS, C = sht_core.NFUN[mode], len(run.fam), A.shape[-1]
	Ap = run.pad_lm(A.permute(2, 0, 1))
	out = torch.zeros((nfun, C, run.nmp, run.ntb, run.TT))
	for il in range(run.first, run.nlb):
		FA = torch.zeros((C, NS, run.nmp, run.ntb, sht_core.BLK_JP))
		FB = torch.zeros_like(FA)
		for l, gAc, gAp, gBc, gBp in run.chains(il):
			for s, prevfam in enumerate(run.fam):
				asn = (Ap[:, l]*run.cs[s, l])[:, :, None, None]
				FA[:, s] += asn*(gAp if prevfam else gAc)
				FB[:, s] += asn*(gBp if prevfam else gBc)
		currf, prevf = run.factors()
		ts = run.to_rings(FA)*currf + run.to_rings(FB)*prevf
		act = run.start <= il
		for f, o in enumerate(sht_core.blk_combine(mode, [ts[:, s] for s in range(NS)], *run.rings)):
			out[f] += torch.where(act, o, torch.zeros(()))
		run.step_state(il)
	return out.view(nfun, C, run.nmp, run.ntp)[:, :, :run.nm, :run.nt]


@pytest.mark.parametrize("mode,C", SYN_MODES)
def test_3xtf32_synthesis_precision_plan(mode, C):
	lmax, theta, mmax, A, state, tab, tab64 = synth_case(mode, C, 21)
	g32 = sht_cuda.geom(theta, mmax, torch.float32, "cpu")
	g64 = sht_cuda.geom(theta, mmax, torch.float64, "cpu")
	ref = sht_core.blk_synthesis(A.double(), state.double(), tab64, g64, lmax, mode)
	e32 = relerr(sht_core.blk_synthesis(A, state, tab, g32, lmax, mode), ref)
	e3 = relerr(tf32_synthesis(A, state, tab, g32, lmax, mode, 3), ref)
	e1 = relerr(tf32_synthesis(A, state, tab, g32, lmax, mode, 1), ref)
	print("%s C=%d: against the float64 twin, float32 %.3e, 3xTF32 %.3e, one TF32 pass %.3e" % (
		mode, C, e32, e3, e1))
	assert ref.abs().max() > 1 and 0 < e32 < 2e-5
	assert e3 <= 2*e32


# ---------------------------------------------------------------------------
# W in fragment order and the dispatch
# ---------------------------------------------------------------------------
def test_w_fragments_built_once():
	theta = rings(LMAX)
	tab, _ = sht_cuda.blk_tables(theta, LMAX, LMAX, "cpu")
	again, _ = sht_cuda.blk_tables(theta.copy(), LMAX, LMAX, "cpu")
	assert again is tab and again.Wfrag is tab.Wfrag
	ntb, TT, JP = -(-len(theta)//sht_cuda.BLK_TILE_T), sht_cuda.BLK_TILE_T, sht_cuda.BLK_JP
	assert tuple(tab.Wfrag.shape) == (ntb, TT//64, JP//8, 128, 4)
	assert tab.Wfrag.dtype == torch.float32 and tab.Wfrag.is_contiguous()
	# lane 4 g + q of warp w, tile T, k-step s: W[8s + q (+4), 64T + 16w + g (+8)]
	W, F = tab.W.numpy(), tab.Wfrag.numpy()
	n, T, s, w, g, q = np.meshgrid(*(np.arange(k) for k in (ntb, TT//64, JP//8, 4, 8, 4)), indexing="ij")
	lane = w*32 + 4*g + q
	for e in range(4):
		j, t = 8*s + q + 4*(e >> 1), 64*T + 16*w + g + 8*(e & 1)
		assert np.array_equal(F[n, T, s, lane, e], W[n, j, t])
	assert np.array_equal(F, sht_cuda.blk_w_fragments(W))
	# the kernel's split of each fragment is tf32_split(W) in the same order
	hi, lo = split(tab.Wfrag)
	Ws = sht_cuda.tf32_split(sht_cuda.blk_node_tables(theta, TT)[1])
	assert np.array_equal(hi.numpy(), sht_cuda.blk_w_fragments(Ws[0]))
	assert np.array_equal(lo.numpy(), sht_cuda.blk_w_fragments(Ws[1]))


def synth_input(theta, ncol):
	return torch.zeros((LMAX + 1, LMAX + 1, ncol)), torch.zeros((3, LMAX + 1, len(theta)))


@pytest.mark.parametrize("mode,C", SYN_MODES)
def test_blk_synthesis_launch_arguments(mode, C, launches):
	"""(C, A, a/b, streams, state, start, nodes, W in fragment order, cos
	theta, ring rows, out, nl, nm, nt, stream), one launch per column chunk:
	6 columns launch C = 4, then 2; C columns alone one launch."""
	theta, tab, g, _, _ = case(mode, 2)
	A, state = synth_input(theta, 6)
	nm, nt = g.nm, g.nt
	out = sht_cuda.blk_synthesis(A, state, tab, g, LMAX, mode)
	assert out.shape == (sht_core.NFUN[mode], 6, nm, nt) and out.dtype == torch.float32
	assert [c[:3] for c in launches] == [("blk_synthesis", mode, False)]*2
	for (_, _, _, args), ncol in zip(launches, (4, 2)):
		assert len(args) == 15 and args[0] == ncol
		assert args[4:8] == (state.data_ptr(), tab.start.data_ptr(), tab.ctv.data_ptr(),
			tab.Wfrag.data_ptr())
		assert args[8:10] == (g.ct.data_ptr(), g.rows.data_ptr())
		assert args[11:] == (LMAX + 1, nm, nt, 0)
	launches.clear()
	sht_cuda.blk_synthesis(A[..., :C].contiguous(), state, tab, g, LMAX, mode)
	assert [c[3][0] for c in launches] == [C]


@pytest.mark.parametrize("mode", ["scalar", "spin2"])
def test_blocked_synthesis_reaches_the_kernel(mode, launches, monkeypatch):
	"""Under sht.blocked(), with BLK_MINL lowered to a CPU size: K3's
	float32 bulk hands its state over and blk_synthesis launches with W in
	fragment order; outside, no block kernel."""
	monkeypatch.setattr(sht_cuda, "BLK_MINL", 256)
	theta, tab, g, _, _ = case(mode, 2)
	A, _ = synth_input(theta, 4 if mode == "spin2" else 2)
	with sht.blocked():
		sht_cuda.blocked_synthesis(A, theta, LMAX, LMAX, mode)
	assert [c[0] for c in launches] == ["full_bulk_synthesis", "blk_synthesis"]
	assert launches[1][3][7] == tab.Wfrag.data_ptr()
	launches.clear()
	sht_cuda.kernel_synthesis(A, theta, LMAX, LMAX, mode, torch.float32)
	assert "blk_synthesis" not in [c[0] for c in launches]


@pytest.mark.parametrize("bad", ["none", "dtype", "device", "shape", "layout"])
def test_blk_synthesis_rejects_fragment_tables(bad, launches):
	theta, tab, g, _, _ = case("scalar", 2)
	A, state = synth_input(theta, 2)
	Wf = tab.Wfrag
	Wf = {"none": None, "dtype": Wf.double(), "device": Wf.to("meta"), "shape": Wf[:, :, :-1].contiguous(),
		"layout": Wf.transpose(3, 4).contiguous().transpose(3, 4)}[bad]
	badtab = sht_core.BlkTables(tab.start, tab.ctv, tab.W, tab.tile_m, tab.tile_t, tab.Wtf32, Wf)
	with pytest.raises(ValueError):
		sht_cuda.blk_synthesis(A, state, badtab, g, LMAX, "scalar")
	assert not launches
	sht_cuda.blk_synthesis(A, state, tab, g, LMAX, "scalar")
	assert len(launches) == 1


def test_synthesis_probes_find_their_places():
	"""chip_smoke.py's blkprobe phase: each probe of SYN_PROBES finds its one
	place in blk_synthesis_kernel, each role starts and flushes its sums
	once, and the reading entry is there."""
	import chip_smoke
	from pixell_tpu_torch.ops import _build
	text = chip_smoke.syn_probed((_build.CSRC/"blockleg.cu").read_text())
	assert text.count("PT_SYN(") == len(chip_smoke.SYN_PROBES) + 1   # and the macro
	assert text.count("PT_SYN_START\n") == 2 and text.count("PT_SYN_FLUSH(") == 2 + 1   # and the macro
	assert "pt_blk_syn_probe" in text
