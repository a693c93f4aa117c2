"""Legendre-stage dispatch and the CUDA kernel wrappers.

Counterpart of pixell_tpu/ops/sht_pallas.py. The kernels themselves are in
pixell_tpu_torch/csrc/legendre.cu, each in the modes scalar, deriv, spin1
and spin2 (K6):

  sym_synthesis   K1, replaces _synthesis_scan_pallas_sym (sht_pallas.py:1686)
  sym_analysis    K2, replaces _analysis_scan_pallas_sym (sht_pallas.py:1850)
  full_synthesis  K3, replaces _synthesis_scan_pallas_full (sht_pallas.py:1540)
  full_analysis   K4, replaces _analysis_scan_pallas_full (sht_pallas.py:1954)

and K3/K4 also in the wigner mode (K7, any spin s; wigner_synthesis_scan_pallas
sht_pallas.py:2165, wigner_analysis_scan_pallas :2221), on a geometry prepared
with that s. K1, K3 and K4 take a table of stop degrees, one per block (the
reference's lstop, which only its K3/K4 take): 0 for a dead block beyond
the horizon of its rings (_dead_table sht_pallas.py:677), which they skip,
and for K3/K4 in float32 Legendre modes any multiple of 8 at which the
block ends early and hands its recurrence state over (dump_state,
sht_pallas.py:1546).

Every launch of K1-K4 runs a kernel redesigned for the card (several rings
a thread, the seed test and level factor out of the steps), templated on
the element type: K2 and K4 bulk_analysis_kernel (the degree sums reduced
8 degrees at a time by a reduce-scatter butterfly), K1 and K3
bulk_synthesis_kernel (K1 with even-l and odd-l sums in place of a mirror
sum). A float32 launch of the wrapper name runs the entry point
BULK_KERNELS[name], a float64 one BULK_F64[name], each counted under its
entry's name.

  polar_analysis  K4's float64 near-pole pass, redesigned for the card
                  (one block per m row, the ring sum in shared memory), in
                  every mode: the counterpart of the float64 analysis that
                  _maybe_polar_analysis (sht_pallas.py:1797) runs through K4
  polar_synthesis K3's float64 near-pole pass, redesigned the same way (one
                  block per m row, the recurrence apart from the sums), in
                  every mode: the counterpart of the float64 synthesis that
                  synthesis_scan_pallas (:498-528) and
                  wigner_synthesis_scan_pallas (:2165-2190) run through K3

The block-Legendre split (K8, sht_pallas.py:556-610) is in csrc/blockleg.cu,
in the four Legendre modes:

  blk_synthesis   K8a/K8b, replaces _synth_blk_call (sht_pallas.py:888) and
                  _synth_blk_call_streams (:1032); redesigned with its
                  node -> ring product on the tensor cores in 3xTF32
                  (wgmma; W in fragment order: blk_w_fragments)
  blk_analysis    K8c/K8d, replaces _anal_blk_call (:1220) and
                  _anal_blk_call_streams (:1350); redesigned with its
                  ring -> node, node-sum and chain-end products on the
                  tensor cores in 3xTF32 (W's split: tf32_split)

They resume from the state K3/K4 dumped and run the oscillatory suffix of
each (m tile, ring tile) 112 degrees at a time. blocked_synthesis /
blocked_analysis drive the split (_synthesis_scan_pallas_blocked :1178,
_analysis_scan_pallas_blocked :1491); the dispatch takes it for float32
Legendre-mode launches of K3/K4 at lmax >= BLK_MINL while BLK_ENABLE is set
(pixell_tpu_torch.sht.blocked()), which it is not by default.

Each wrapper takes prepared tables (sht_core.Geom plus the coefficient
tables built here), checks its arguments, and launches its kernel on a CUDA
tensor, adding one to LAUNCHES[name], to LAUNCHES_BY_MODE[(name, mode)] and
to LAUNCHES_BY_DTYPE[(name, mode, "float32" or "float64")], and for a launch
on an m block (m0 > 0) to LAUNCHES_MBLOCK under the same key.
On a CPU tensor it runs its plain PyTorch version (PLAIN[name], same
arguments) instead; on any other device it raises.

An m block: the columns m0 .. mmax of a transform run on their own (the
m-sharded SHT gives each rank its contiguous block). The geometry
(geom(..., m0=m0)), the coefficient tables and the dead-tile table are the
block's rows, and every launch of K1-K4 and of the near-pole passes takes
the block's first m as its last argument (mfirst in csrc/legendre.cu), from
which the kernel derives each row's true m: its seed degree, its mode
functions and its half-sky parity. The dispatch takes m0 (keyword) and runs
the near-pole pass on the block's columns below its m-extent. The
block-Legendre split does not run on an m block: it raises
NotImplementedError.

synthesis_scan / analysis_scan are the engine entry points the SHT calls.
CPU tensors go to the plain scan (sht_core); CUDA tensors go through the
reference's dispatch (synthesis_scan_pallas :498,
analysis_scan_pallas_chunked :2108, _maybe_polar_analysis :1797,
_analysis_sym_entry :1825), with its thresholds, in every mode:
  - float32: bulk rings use K1/K2 when the ring set is south-symmetric with
    at most 2*SYM_MAX_NH rings, else K3/K4 in float32. The rings within
    POLAR_AMP/lmax of a pole, for m < POLAR_MMAX, then run in float64 (the
    TPU ran them in double-single): synthesis through polar_synthesis, which
    overwrites those rings, analysis through polar_analysis, whose
    contribution is added. A ring set that lies wholly near the poles runs in float64
    through K1-K4.
  - float64: K1-K4 in float64 (BULK_F64), with no polar split.
  - wigner mode (wigner_synthesis_scan_pallas :2165, wigner_analysis_scan_pallas
    :2221): always K3/K4, the near-pole pass (polar_synthesis,
    polar_analysis) for
    m < max(POLAR_MMAX, s + 1).
  - the dead-tile stops go to every float32 launch of K1, K3 and K4 (K1's
    from its northern rings, whose mirrors share their sin theta), with the
    mode's s (0 for the Legendre modes). The float64 launches compute every
    tile: the skipped terms, ~1e-12 of the peak and up to ~1e-7 in spin 2,
    are above what a float64 transform promises.
"""
from __future__ import annotations
import ctypes
import functools
import numpy as np
import torch
from . import sht_core, _build, tablecache
from .sht_core import NFUN, PSIGN

SYM_MAX_NH = 1536   # half-sky kernels only up to 2*SYM_MAX_NH rings
POLAR_AMP = 60.0    # near-pole rings: theta < POLAR_AMP/lmax (and mirrored)
POLAR_MMAX = 128    # m-extent of the near-pole pass
TCHUNK = 2048       # rings per analysis chunk
MAX_PLANES = 8      # partial-sum planes per analysis kernel launch
KERNEL_C = (4, 2)   # coefficient columns a kernel instantiation takes
TILE_M, TILE_T = 4, 64   # m rows and rings of a kernel block (csrc/legendre.cu MY, TX)

# The block-Legendre split (pixell_tpu/ops/sht_pallas.py:587-610)
BLK_LB, BLK_JP = sht_core.BLK_LB, sht_core.BLK_JP   # degrees per block, nodes per ring tile
BLK_GMAX = 3.0      # growth bits a block may have at its tile's worst corner
BLK_MINL = 1024     # the split engages from this lmax on
BLK_ENABLE = False  # set by pixell_tpu_torch.sht.blocked()
BLK_TILE_M, BLK_TILE_T = 4, 256   # m rows and rings of a block-kernel tile (csrc/blockleg.cu BM, BT)
BLK_SMIN = 0.5      # the split keeps to ring tiles with sin(theta) >= BLK_SMIN (blk_polar_tiles)

# the entry points of K1-K4 by wrapper name: bulk_synthesis_kernel and
# bulk_analysis_kernel, float32 (BULK_KERNELS) and float64 (BULK_F64)
BULK_KERNELS = {"sym_synthesis": "sym_bulk_synthesis", "full_synthesis": "full_bulk_synthesis",
	"sym_analysis": "sym_bulk_analysis", "full_analysis": "full_bulk_analysis"}
BULK_F64 = {name: entry + "_f64" for name, entry in BULK_KERNELS.items()}
BLK_KERNELS = ("blk_synthesis", "blk_analysis")
POLAR_KERNELS = ("polar_analysis", "polar_synthesis")
KERNELS = tuple(BULK_KERNELS.values()) + tuple(BULK_F64.values()) + POLAR_KERNELS + BLK_KERNELS
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_MODE = {(name, mode): 0 for name in KERNELS for mode in sht_core.MODES}
LAUNCHES_BY_DTYPE = {k + (dt,): 0 for k in LAUNCHES_BY_MODE for dt in ("float32", "float64")}
# the launches of K1-K4 and the near-pole passes on an m block that does not
# start at m = 0, by (name, mode, dtype), counted in LAUNCHES_BY_DTYPE too
LAUNCHES_MBLOCK = dict.fromkeys(LAUNCHES_BY_DTYPE, 0)


def reset_launches():
	for d in (LAUNCHES, LAUNCHES_BY_MODE, LAUNCHES_BY_DTYPE, LAUNCHES_MBLOCK):
		for k in d: d[k] = 0


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------
def detect_sym(theta):
	"""Number of northern rings nh if theta (ascending, float64) is
	south-symmetric (theta[::-1] == pi - theta) with 16..2*SYM_MAX_NH rings,
	else None (pixell_tpu.ops.sht_pallas._detect_sym). Ring i pairs with
	nt-1-i; for odd nt the middle ring pairs with itself."""
	th = np.asarray(theta, np.float64)
	if th.ndim != 1 or th.shape[0] < 16 or th.shape[0] > 2*SYM_MAX_NH: return None
	if not np.allclose(th[::-1], np.pi - th, atol=1e-6): return None
	return (th.shape[0] + 1)//2


def polar_counts(theta, lmax):
	"""(n_north, n_south): rings within POLAR_AMP/lmax of either pole, for
	ascending theta (pixell_tpu.ops.sht_pallas._polar_counts)."""
	th = np.asarray(theta, np.float64)
	tcut = POLAR_AMP/max(lmax, 1)
	return int(np.searchsorted(th, tcut)), int(np.sum(th > np.pi - tcut))


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def host_coef(nl, nm, ndt, m0=0):
	"""[3, nl, nm] numpy ndt: a_lm, b_lm and e_lm by the formulas of
	sht_core.recur_ab and recur_e, evaluated in ndt with numpy's IEEE
	(correctly rounded) sqrt and divide, for m = m0 .. m0 + nm - 1."""
	l = np.arange(nl, dtype=ndt)[:, None]
	m = np.arange(m0, m0 + nm, dtype=ndt)[None, :]
	a = np.sqrt(np.maximum((2*l - 1)*(2*l + 1), 0)/np.maximum((l - m)*(l + m), 0.25))
	b = np.sqrt(np.maximum((l - 1 - m)*(l - 1 + m), 0)/np.maximum((2*l - 3)*(2*l - 1), 1))
	e = np.sqrt(np.maximum((l - m)*(l + m)*(2*l + 1), 0)/np.maximum(2*l - 1, 1))
	return np.stack([a, b, e])


def host_wigner(nl, nm, s, m0=0):
	"""[3, nl, nm] float64 numpy: a, b, c of the Wigner-d recurrence at spin s
	by the formulas of sht_core.wigner_abc, for m = m0 .. m0 + nm - 1."""
	l = np.arange(nl, dtype=np.float64)[:, None]
	m = np.arange(m0, m0 + nm, dtype=np.float64)[None, :]
	sf = float(s)
	def v(lv):
		num = np.maximum((lv - m)*(lv + m)*(lv - sf)*(lv + sf), 0)
		den = np.maximum(lv*np.sqrt(np.maximum(4*lv*lv - 1, 0)), 1)
		return np.sqrt(num)/den
	vl = v(l)
	a = np.where(vl > 0, 1/np.maximum(vl, 1e-30), 0)
	c = m*sf/np.maximum((l - 1)*l, 1)
	live = l > np.maximum(m, sf)
	return np.stack([np.where(live, t, 0) for t in (a, v(l - 1), c)])


def host_l_norms(mode, nl, ndt):
	"""[2, nl] numpy ndt: nrm and hp of the mode functions by the formulas of
	sht_core.l_norms."""
	l = np.arange(nl, dtype=ndt)
	if mode == "deriv":
		nrm = np.sqrt(np.maximum(l*(l + 1), 0))
	elif mode == "spin1":
		nrm = 1/np.sqrt(np.maximum(l*(l + 1), 1))
	else:
		nrm = 1/np.sqrt(np.maximum((l - 1)*l*(l + 1)*(l + 2), 1))
	return np.stack([nrm, np.sqrt((2*l + 1)/(4*np.pi))/2])


def coef_tables(nl, nm, dtype, device=None, m0=0):
	"""[3, nl, nm]: the recurrence coefficients a_lm, b_lm and the mode
	functions' e_lm (pixell_tpu.ops.sht_pallas._recur_ab_tables :88) for
	m = m0 .. m0 + nm - 1, computed on the host in dtype by numpy
	(host_coef), whose sqrt and divide are correctly rounded, and copied
	to device."""
	return torch.from_numpy(host_coef(nl, nm, _NP_DTYPE[dtype], m0)).to(device)


def wigner_tables(nl, nm, s, dtype, device=None, m0=0):
	"""[3, nl, nm]: a = 1/v(l), b = v(l-1) and c = m s/((l-1) l) of the
	Wigner-d recurrence for spin s (sht_core.wigner_abc; pixell_tpu.ops.
	sht_pallas._wigner_ab_tables :108), zero for l <= max(m, s). The two
	branches share a and b and take +c and -c. Computed on the host in
	float64 by numpy (host_wigner) and rounded once to dtype: near the poles
	the recurrence amplifies the rounding of c by ~l^2, so the float64
	near-pole pass reads float64 tables. m as in coef_tables."""
	return torch.from_numpy(host_wigner(nl, nm, s, m0).astype(_NP_DTYPE[dtype])).to(device)


def l_tables(nl, mode, dtype, device=None):
	"""[2, nl]: the per-degree norm and half pole factor of the mode
	functions (sht_core.l_norms), computed on the host in dtype by numpy
	(host_l_norms); zeros in the scalar and wigner modes, which read none."""
	if mode in ("scalar", "wigner"): return torch.zeros((2, nl), dtype=dtype, device=device)
	return torch.from_numpy(host_l_norms(mode, nl, _NP_DTYPE[dtype])).to(device)


def dead_table(theta, lmax, mmax, tile_m, tile_t, s=0, m0=0):
	"""[ceil(nm/tile_m), ceil(nt/tile_t)] bool: True where a tile of tile_m
	m rows by tile_t rings lies wholly beyond the horizon,
	m_lo - s > lmax max(sin theta) + 1.6 sqrt(lmax) + 20, so that every
	lambda_lm (or d^l_ms) on it is below ~1e-12 for every l <= lmax
	(pixell_tpu.ops.sht_pallas._dead_table :677). s is 0 for the Legendre
	modes, which are all built on lambda_lm, and the spin in wigner mode.
	On the m block m0 .. mmax (nm = mmax + 1 - m0) the tiles start at row 0
	of the block, and m_lo is a tile's true first m."""
	th = np.asarray(theta, np.float64)
	nmb, ntb = -(-(mmax + 1 - m0)//tile_m), -(-len(th)//tile_t)
	st = np.zeros(ntb*tile_t)
	st[:len(th)] = np.sin(th)
	smax = st.reshape(ntb, tile_t).max(1)
	slack = 1.6*np.sqrt(max(lmax, 1)) + 20
	m_lo = m0 + np.arange(nmb)*tile_m
	return (m_lo[:, None] - s) > (lmax*smax[None, :] + slack)


@tablecache.cached
def _dead_cached(theta_bytes, lmax, mmax, s, device, m0=0):
	dead = dead_table(np.frombuffer(theta_bytes, np.float64), lmax, mmax, TILE_M, TILE_T, s, m0)
	if not dead.any(): return None
	return torch.from_numpy(np.where(dead, 0, lmax + 1).astype(np.int32)).to(device)


def dead_stops(theta, lmax, mmax, s, device, m0=0):
	"""The stop degrees that make K1/K3/K4 skip their dead blocks on the rings
	theta: an int32 tensor [ceil(nm/TILE_M), ceil(nt/TILE_T)] on device, 0
	for a dead block and lmax + 1 (run to the end) for the others, or None
	where no block is dead (pixell_tpu.ops.sht_pallas._dead_lstop :704);
	with m0, for the m block m0 .. mmax. Cached per ring set."""
	th = np.ascontiguousarray(theta, np.float64)
	return _dead_cached(th.tobytes(), int(lmax), int(mmax), int(s), torch.device(device), int(m0))


def stop_entries(lstop, nm, nt):
	"""[nm, nt] int32 from a table of stop degrees per block: each entry's."""
	return lstop.repeat_interleave(TILE_M, 0).repeat_interleave(TILE_T, 1)[:nm, :nt]


def live_mask(lstop, nm, nt):
	"""[nm, nt] bool from a table of stop degrees: the entries K3/K4 compute."""
	return stop_entries(lstop, nm, nt) > 0


# ---------------------------------------------------------------------------
# Host tables of the block-Legendre split
# ---------------------------------------------------------------------------
def blk_start_table(theta, lmax, mmax, tile_m, tile_t):
	"""[ceil(nm/tile_m), ceil(nt/tile_t)] int32: per tile of tile_m m rows by
	tile_t rings, the first BLK_LB-degree block from which every block up to
	lmax is eligible for the block kernels; nlb = ceil(nl/BLK_LB) where none
	is (pixell_tpu.ops.sht_pallas._blk_start_table :621). A block starting at
	l0 is eligible when it holds no seed (l0 > the tile's largest m, l0 >= 2)
	and the recurrence's dominant root, at the tile's worst corner (largest
	m, largest |cos theta|), grows by at most BLK_GMAX bits over the block:
	the tile is then oscillatory there, the node series stay O(1) and their
	evaluation error ~BLK_JP eps. A tile straddling the turning point is
	not: its series would span 2^G and swamp its small values. Tiles with a
	pole ring are never eligible: the block kernels have no pole terms."""
	th = np.asarray(theta, np.float64)
	nt, nm, nl = len(th), mmax + 1, lmax + 1
	nmb, ntb, nlb = -(-nm//tile_m), -(-nt//tile_t), -(-nl//BLK_LB)
	ct = np.zeros(ntb*tile_t)
	ct[:nt] = np.cos(th)
	cta = np.abs(ct).reshape(ntb, tile_t).max(1)[:, None]
	stp = np.ones(ntb*tile_t)
	stp[:nt] = np.abs(np.sin(th))
	has_pole = (stp < 1e-6).reshape(ntb, tile_t).any(1)
	ls = np.arange(nlb*BLK_LB, dtype=np.float64)
	l0s = np.arange(nlb)*BLK_LB
	start = np.full((nmb, ntb), nlb, np.int32)
	for imb in range(nmb):
		m_hi = min((imb + 1)*tile_m, nm) - 1
		a = np.sqrt(np.maximum((2*ls - 1)*(2*ls + 1), 0.0)
			/ np.maximum((ls - m_hi)*(ls + m_hi), 0.25))
		b = np.sqrt(np.maximum((ls - 1 - m_hi)*(ls - 1 + m_hi), 0.0)
			/ np.maximum((2*ls - 3)*(2*ls - 1), 1.0))
		# log2 of the dominant root of z^2 - a c z + a b per degree, [ntb, nlp]
		disc = (a*cta)**2 - 4*a*b
		z = np.where(disc > 0, (a*cta + np.sqrt(np.maximum(disc, 0.0)))/2, 1.0)
		gb = np.log2(np.maximum(z, 1.0)).reshape(ntb, nlb, BLK_LB).sum(2)
		ok = (gb <= BLK_GMAX) & (l0s > m_hi) & (l0s >= 2)
		# the first block of the trailing run of eligible ones
		bad = ~ok[:, ::-1]
		start[imb] = np.where(bad.any(1), nlb - np.argmax(bad, 1), 0)
	start[:, has_pole] = nlb
	return start


def blk_polar_tiles(theta, tile_t):
	"""[ceil(nt/tile_t)] bool: the ring tiles of tile_t rings that hold a ring
	with sin theta < BLK_SMIN, which the port never runs blocked. A bound the
	reference's 128-row m tiles did not need: towards a pole the recurrence's
	roots meet and the node series grow algebraically, by min(BLK_LB,
	1/sin theta), at any m, so the blocked evaluation's error grows as
	1/sin^2 theta (measured on an H100 at lmax 2000: 4e-6/sin^2 theta of the
	largest value, at the tile's most polar ring), and the node -> ring
	product spreads it over the whole tile. With tiles of a few m rows the
	root bound of blk_start_table alone passes such tiles at low m; with
	BLK_SMIN the error stays below 2e-5."""
	st = np.abs(np.sin(np.asarray(theta, np.float64)))
	return np.array([st[i:i + tile_t].min() < BLK_SMIN for i in range(0, len(st), tile_t)])


def blk_split(start, dead, lmax):
	"""(start, stop): the block kernels' start table with the dead tiles
	taken out, and the stop degree of the stepwise kernel per tile: 0 on a
	dead tile (neither kernel runs it), else BLK_LB start, which is past lmax
	where the tile has no blocked suffix
	(pixell_tpu.ops.sht_pallas._synthesis_scan_pallas_blocked :1189-1197)."""
	nlb = -(-(lmax + 1)//BLK_LB)
	start = np.where(dead, nlb, start).astype(np.int32)
	return start, np.where(dead, 0, start*BLK_LB).astype(np.int32)


def lagrange_basis(xn, x):
	"""[len(xn), len(x)] float64: l_j(x_t), the Lagrange basis through the
	nodes xn at the points x, in barycentric form."""
	d = xn[:, None] - xn[None, :]
	np.fill_diagonal(d, 1.0)
	w = 1/np.prod(d, 1)
	diff = x[None, :] - xn[:, None]
	hit = diff == 0
	terms = w[:, None]/np.where(hit, 1.0, diff)
	L = terms/terms.sum(0)
	at_node = hit.any(0)
	L[:, at_node] = hit[:, at_node]
	return L


def blk_node_tables(theta, tile_t):
	"""(ctv [ntb, BLK_JP], W [ntb, BLK_JP, tile_t]) float64 numpy: per ring
	tile the Chebyshev-Gauss nodes of its rings' cos theta interval, as the
	float32 numbers the kernels evaluate their chains at, and W[n, j, t] =
	l_j(cos theta_t), the Lagrange basis through exactly those numbers at the
	tile's rings, zero on padding rings (pixell_tpu.ops.sht_pallas.
	_blk_node_tables :847). Built in float64 from the exact cos theta: the
	node -> ring product then interpolates every polynomial of degree < BLK_JP
	exactly, whatever the rounding of the nodes. (The reference forms W for
	the ideal nodes in a float32 recurrence, the TPU having no float64.)"""
	ct = np.cos(np.asarray(theta, np.float64))
	nt = len(ct)
	ntb = -(-nt//tile_t)
	xn = np.cos(np.pi*(np.arange(BLK_JP) + 0.5)/BLK_JP)
	ctv = np.zeros((ntb, BLK_JP))
	W = np.zeros((ntb, BLK_JP, tile_t))
	for n in range(ntb):
		c = ct[n*tile_t:(n + 1)*tile_t]
		c0 = (c.max() + c.min())/2
		# wide enough that float32 keeps the nodes apart
		h = max((c.max() - c.min())/2, 1e-3)
		ctv[n] = (c0 + h*xn).astype(np.float32)
		W[n, :, :len(c)] = lagrange_basis((ctv[n] - c0)/h, (c - c0)/h)
	return ctv, W


def tf32_split(x):
	"""[2, ...] float32 numpy: x in float32 as the sum of two TF32 numbers
	(10 mantissa bits, rounded to nearest, ties to even), hi = tf32(x) and
	lo = tf32(x - hi): the operands of the analysis kernel's 3xTF32
	products, whose lo x lo term is 2^-22 of x's."""
	def tf32(v):
		u = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(np.uint64)
		u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
		return u.astype(np.uint32).view(np.float32)
	x = np.asarray(x, np.float32)
	hi = tf32(x)
	return np.stack([hi, tf32(x - hi)])


def blk_w_fragments(W):
	"""[ntb, tile_t//64, BLK_JP//8, 128, 4] float32 numpy: W [ntb, BLK_JP,
	tile_t] in the order blk_synthesis_kernel reads it as the A operand of
	its node -> ring product (rings as rows, nodes as the reduced axis), one
	64-ring tile and k-step of 8 nodes at a time: lane 4 g + q of warp w
	holds (W[8 s + q, t], W[8 s + q, t + 8], W[8 s + q + 4, t], W[8 s + q +
	4, t + 8]) at t = 64 T + 16 w + g, the wgmma A fragment of rows t, t + 8
	and columns q, q + 4. The kernel splits it into TF32 hi and lo itself."""
	W = np.asarray(W, np.float32)
	ntb, jp, tt = W.shape
	# j = 8 s + 4 kh + q, t = 64 T + 16 w + 8 th + g -> [n, T, s, w, g, q, kh, th]
	Wr = W.reshape(ntb, jp//8, 2, 4, tt//64, 4, 2, 8)
	return np.ascontiguousarray(Wr.transpose(0, 4, 1, 5, 7, 3, 2, 6)).reshape(ntb, tt//64, jp//8, 128, 4)


@functools.lru_cache(maxsize=16)
def _blk_cached(theta_bytes, lmax, mmax, device):
	theta = np.frombuffer(theta_bytes, np.float64)
	start = blk_start_table(theta, lmax, mmax, BLK_TILE_M, BLK_TILE_T)
	start[:, blk_polar_tiles(theta, BLK_TILE_T)] = -(-(lmax + 1)//BLK_LB)
	start, stop = blk_split(start, dead_table(theta, lmax, mmax, BLK_TILE_M, BLK_TILE_T), lmax)
	nosuffix = start*BLK_LB > lmax
	if nosuffix.all(): return None
	# K3/K4's own blocks: each takes its tile's stop degree; in a tile without
	# a suffix it skips if dead, as on the unsplit path
	rm, rt = BLK_TILE_M//TILE_M, BLK_TILE_T//TILE_T
	dead = dead_table(theta, lmax, mmax, TILE_M, TILE_T)
	spread = lambda x: np.repeat(np.repeat(x, rm, 0), rt, 1)[:dead.shape[0], :dead.shape[1]]
	lstop = np.where(spread(nosuffix), np.where(dead, 0, lmax + 1), spread(stop)).astype(np.int32)
	ctv, W = blk_node_tables(theta, BLK_TILE_T)
	f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
	tab = sht_core.BlkTables(f(start), f(ctv.astype(np.float32)), f(W.astype(np.float32)),
		BLK_TILE_M, BLK_TILE_T, f(tf32_split(W)), f(blk_w_fragments(W)))
	return tab, f(lstop)


def blk_tables(theta, lmax, mmax, device):
	"""(tables of the block kernels, stop degrees of K3/K4's blocks) for the
	split on the rings theta in float32, or None where no tile has a blocked
	suffix. Cached per ring set."""
	if BLK_TILE_M % TILE_M or BLK_TILE_T % TILE_T:
		raise RuntimeError("a block-kernel tile must be whole K3/K4 blocks")
	th = np.ascontiguousarray(theta, np.float64)
	return _blk_cached(th.tobytes(), int(lmax), int(mmax), torch.device(device))


@tablecache.cached
def _coef_cached(nl, nm, dtype, device, s=None, m0=0):
	if s is not None: return wigner_tables(nl, nm, s, dtype, device, m0)
	return coef_tables(nl, nm, dtype, device, m0)


@tablecache.cached
def _lt_cached(nl, mode, dtype, device):
	return l_tables(nl, mode, dtype, device)


@functools.lru_cache(maxsize=8)
def _streams_cached(nl, nm, mode, device):
	return sht_core.blk_stream_tables(nl, nm, mode, torch.float32, device).contiguous()


@tablecache.cached
def _geom_cached(theta_bytes, mmax, dtype, device, s, m0=0):
	theta = np.frombuffer(theta_bytes, np.float64)
	return sht_core.prepare_geom(theta, mmax, dtype, device, s, m0)


def geom(theta, mmax, dtype, device, s=None, m0=0):
	"""Seeds, two-part cos(theta) and mode rows for the rings theta, cached
	per ring set, dtype and device (pixell_tpu.ops.sht_pallas._prep_inputs
	:468 and _ct_parts :454); with s, for the wigner mode at spin s; with
	m0, for the m block m0 .. mmax."""
	th = np.ascontiguousarray(theta, np.float64)
	return _geom_cached(th.tobytes(), int(mmax), dtype, torch.device(device),
		None if s is None else int(s), int(m0))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def library(csrc=_build.CSRC):
	"""The kernel library built from csrc (by default the package's
	sources), with argument types declared."""
	lib = _build.load(csrc)
	P, I = ctypes.c_void_p, ctypes.c_int
	for mode in sht_core.MODES:
		for name in tuple(BULK_KERNELS.values()) + tuple(BULK_F64.values()):
			if mode == "wigner" and name.startswith("sym"): continue   # no half-sky form
			fn = getattr(lib, "pt_%s_%s" % (name, mode))
			# C, 9 pointers, (nl, nm, nt[, nplanes], s), the stop degrees, the state,
			# the stream, the m block's first m
			fn.argtypes = [I] + [P]*9 + [I]*(4 if "synthesis" in name else 5) + [P]*3 + [I]
			fn.restype = I
		fn = getattr(lib, "pt_polar_analysis_%s" % mode)
		# C, 8 pointers, (ldo, nl, nm, nt, s), the stream, the m block's first m
		fn.argtypes = [I] + [P]*8 + [I]*5 + [P, I]
		fn.restype = I
		fn = getattr(lib, "pt_polar_synthesis_%s" % mode)
		# C, 8 pointers, (lda, ldo, nl, nm, nt, s), the stream, the m block's first m
		fn.argtypes = [I] + [P]*8 + [I]*6 + [P, I]
		fn.restype = I
		if mode not in sht_core.BLK_FAM: continue
		for name in BLK_KERNELS:
			fn = getattr(lib, "pt_%s_%s" % (name, mode))
			# C, 10 pointers, (nl, nm, nt[, nplanes]), the stream
			fn.argtypes = [I] + [P]*10 + [I]*(3 if name.endswith("synthesis") else 4) + [P]
			fn.restype = I
	for fn, want in ((lib.pt_tile_theta_scalar, TILE_T), (lib.pt_tile_m_scalar, TILE_M),
			(lib.pt_blk_tile_theta_scalar, BLK_TILE_T), (lib.pt_blk_tile_m_scalar, BLK_TILE_M),
			(lib.pt_blk_degrees_scalar, BLK_LB), (lib.pt_blk_nodes_scalar, BLK_JP)):
		fn.argtypes, fn.restype = [], I
		if fn() != want:
			raise RuntimeError("the built kernels' tiles are not the dispatch's (%d, not %d)"
				% (fn(), want))
	return lib


def _on_card(x):
	"""True for a CUDA tensor (launch the kernel), False for a CPU tensor
	(run the plain version); any other device raises."""
	if x.device.type == "cuda": return True
	if x.device.type == "cpu": return False
	raise RuntimeError("no Legendre kernel for device '%s'" % x.device)


def _check(x, g, shape, what):
	if x.dtype != g.dtype:
		raise TypeError("%s: dtype %s does not match the geometry's %s" % (what, x.dtype, g.dtype))
	if x.device != g.ct.device:
		raise ValueError("%s: tensor on %s, geometry on %s" % (what, x.device, g.ct.device))
	if tuple(x.shape) != tuple(shape):
		raise ValueError("%s: shape %s, expected %s" % (what, tuple(x.shape), tuple(shape)))
	if max(shape) >= 2**31:
		raise ValueError("%s: shape %s too large" % (what, tuple(x.shape)))


def _ptrs(g, ab, lt):
	return [ab.data_ptr(), lt.data_ptr(), g.ct.data_ptr(), g.ct_lo.data_ptr(),
		g.rows.data_ptr(), g.seed_val.data_ptr(), g.seed_level.data_ptr()]


def _stream(x):
	"""The current CUDA stream of x's device, as the entry points take it."""
	return torch.cuda.current_stream(x.device).cuda_stream


def _launch(name, mode, device, f64, *args):
	# the C entry points launch on the thread's current device
	with torch.cuda.device(device):
		err = getattr(library(), "pt_%s_%s" % (name, mode))(*args)
	if err != 0:
		raise RuntimeError("%s (%s) kernel launch failed: CUDA error %d" % (name, mode, err))
	LAUNCHES[name] += 1
	LAUNCHES_BY_MODE[(name, mode)] += 1
	key = (name, mode, "float64" if f64 else "float32")
	LAUNCHES_BY_DTYPE[key] += 1
	# the Legendre entries' last argument is the m block's first m
	if name not in BLK_KERNELS and args and args[-1]: LAUNCHES_MBLOCK[key] += 1


def _mode_args(g, nl, mode, lstop, device, dump_state=False):
	"""(ab, lt, s, stop-degree pointer) of a launch in mode on geometry g,
	after checking that the geometry fits the mode, the stop degrees the grid
	and a state handoff its launch."""
	if (mode == "wigner") != (g.s is not None):
		raise ValueError("mode '%s' on a geometry prepared %s a spin" % (mode,
			"without" if g.s is None else "with"))
	if lstop is not None:
		want = (-(-g.nm//TILE_M), -(-g.nt//TILE_T))
		if lstop.dtype != torch.int32 or lstop.device != device or tuple(lstop.shape) != want \
				or not lstop.is_contiguous():
			raise ValueError("stop degrees: need contiguous int32 %s on %s" % (want, device))
	if dump_state and (lstop is None or mode == "wigner" or g.dtype != torch.float32):
		raise ValueError("the state is handed over by float32 Legendre-mode launches "
			"with stop degrees only")
	if lstop is not None and g.dtype != torch.float32:
		raise ValueError("stop degrees are taken by float32 launches only")
	return (_coef_cached(nl, g.nm, g.dtype, device, g.s, g.m0), _lt_cached(nl, mode, g.dtype, device),
		0 if g.s is None else int(g.s), 0 if lstop is None else lstop.data_ptr())


def _col_chunks(C):
	"""Split C coefficient columns into launches of KERNEL_C widths, widest
	first: a spin-2 block (C = 4) runs its recurrence once. C is even, as
	the SHT's (re, im) column pairs make it."""
	if C % 2: raise ValueError("the kernels take an even number of columns, not %d" % C)
	out, c0 = [], 0
	while c0 < C:
		w = next(k for k in KERNEL_C if k <= C - c0)
		out.append((c0, c0 + w)); c0 += w
	return out


def _new_state(g, dump_state, device):
	"""(state [3, nm, nt] for the kernel to fill, its pointer), or (None, 0)."""
	if not dump_state: return None, 0
	state = torch.zeros((3, g.nm, g.nt), dtype=g.dtype, device=device)
	return state, state.data_ptr()


def _synthesis_launch(name, A, g, lmax, mode, out_shape_of, lstop=None, dump_state=False):
	"""K1 / K3 on the card: bulk_synthesis_kernel, its float32 entry
	(BULK_KERNELS[name]) or its float64 one (BULK_F64[name])."""
	nl, nm, C = A.shape
	ab, lt, s, stop_ptr = _mode_args(g, nl, mode, lstop, A.device, dump_state)
	stream = _stream(A)
	state, state_ptr = _new_state(g, dump_state, A.device)
	f64 = g.dtype == torch.float64
	entry = (BULK_F64 if f64 else BULK_KERNELS)[name]
	outs = []
	for c0, c1 in _col_chunks(C):
		Ac = A[..., c0:c1].contiguous()
		out = torch.empty(out_shape_of(c1 - c0), dtype=g.dtype, device=A.device)
		# every launch of the columns ends in the same state: the first writes it
		_launch(entry, mode, A.device, f64, c1 - c0, Ac.data_ptr(), *_ptrs(g, ab, lt),
			out.data_ptr(), nl, nm, g.nt, s, stop_ptr, state_ptr if c0 == 0 else 0, stream, g.m0)
		outs.append(out)
	G = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
	return (G, state) if dump_state else G


def _planes(ntiles):
	"""Partial-sum planes for ntiles ring tiles: each loops over an equal share."""
	return -(-ntiles//(-(-ntiles//MAX_PLANES)))


def _analysis_launch(name, F, g, lmax, mode, lstop=None, dump_state=False):
	"""K2 / K4 on the card: bulk_analysis_kernel, its float32 entry
	(BULK_KERNELS[name]) or its float64 one (BULK_F64[name])."""
	C = F.shape[1]
	nl, nm = lmax + 1, g.nm
	ab, lt, s, stop_ptr = _mode_args(g, nl, mode, lstop, F.device, dump_state)
	stream = _stream(F)
	state, state_ptr = _new_state(g, dump_state, F.device)
	nplanes = _planes(-(-g.nt//TILE_T))
	f64 = g.dtype == torch.float64
	entry = (BULK_F64 if f64 else BULK_KERNELS)[name]
	outs = []
	for c0, c1 in _col_chunks(C):
		Fc = F[:, c0:c1].contiguous()
		part = torch.zeros((nplanes, nl, nm, c1 - c0), dtype=g.dtype, device=F.device)
		_launch(entry, mode, F.device, f64, c1 - c0, Fc.data_ptr(), *_ptrs(g, ab, lt),
			part.data_ptr(), nl, nm, g.nt, nplanes, s, stop_ptr, state_ptr if c0 == 0 else 0, stream,
			g.m0)
		outs.append(part.sum(0))
	A = torch.cat(outs, -1)
	return (A, state) if dump_state else A


def _parity(nl, nm, dtype, device, m0=0):
	"""(-1)^(l+m) as [nl, nm], for m = m0 .. m0 + nm - 1."""
	lm = torch.arange(nl, device=device)[:, None] + torch.arange(m0, m0 + nm, device=device)[None, :]
	return (1 - 2*(lm % 2)).to(dtype)


def _psign(mode, dtype, device):
	return torch.tensor(PSIGN[mode], dtype=dtype, device=device)


def _sym_synthesis_plain(A, g, lmax, mode="scalar", lstop=None):
	C = A.shape[-1]
	sgn = _parity(lmax + 1, g.nm, A.dtype, A.device, g.m0)[..., None]
	# one pass: the mirror ring is sum_l PSIGN[f] (-1)^(l+m) u_f A; a mirror
	# ring stops where its northern ring does
	G = sht_core.synthesis(torch.cat([A, A*sgn], -1), g, lmax, mode,
		None if lstop is None else stop_entries(lstop, g.nm, g.nt))   # [nfun, 2C, nm, nh]
	mirror = G[:, C:]*_psign(mode, G.dtype, G.device)[:, None, None, None]
	return torch.stack([G[:, :C], mirror], 2)

def _even_odd(EO, mode):
	"""EO [nfun, C, 2, nm, nh] -> [nfun, 2C, nm, nh]: for each function the
	plane it reads at even l+m, then the one at odd l+m. Function f reads
	the even plane where PSIGN[f] (-1)^(l+m) = +1."""
	even = torch.stack([EO[f, :, 0 if s > 0 else 1] for f, s in enumerate(PSIGN[mode])])
	odd = torch.stack([EO[f, :, 1 if s > 0 else 0] for f, s in enumerate(PSIGN[mode])])
	return torch.cat([even, odd], 1)

def _sym_analysis_plain(EO, g, lmax, mode="scalar"):
	C = EO.shape[1]
	# one pass for the even (l+m), one for the odd, selected per (l, m)
	R = sht_core.analysis(_even_odd(EO, mode), g, lmax, mode)   # [nl, nm, 2C]
	lodd = _parity(lmax + 1, g.nm, torch.int64, EO.device, g.m0)[..., None] < 0
	return torch.where(lodd, R[..., C:], R[..., :C])

def _full_synthesis_plain(A, g, lmax, mode="scalar", lstop=None, dump_state=False):
	return sht_core.synthesis(A, g, lmax, mode,
		None if lstop is None else stop_entries(lstop, g.nm, g.nt), dump_state)

def _full_analysis_plain(F, g, lmax, mode="scalar", lstop=None, dump_state=False):
	return sht_core.analysis(F, g, lmax, mode,
		None if lstop is None else stop_entries(lstop, g.nm, g.nt), dump_state)

def _polar_analysis_plain(F, g, lmax, mode="scalar"):
	return sht_core.analysis(F, g, lmax, mode)

def _polar_synthesis_plain(A, g, lmax, mode="scalar"):
	return sht_core.synthesis(A, g, lmax, mode)

# The plain PyTorch version of each kernel, on the same arguments (mode,
# stop degrees and tables included). The wrappers use it for CPU tensors; it
# runs on any device.
PLAIN = {"sym_synthesis": _sym_synthesis_plain, "sym_analysis": _sym_analysis_plain,
	"full_synthesis": _full_synthesis_plain, "full_analysis": _full_analysis_plain,
	"polar_analysis": _polar_analysis_plain, "polar_synthesis": _polar_synthesis_plain,
	"blk_synthesis": sht_core.blk_synthesis, "blk_analysis": sht_core.blk_analysis}


def _check_sym_mode(mode):
	sht_core.check_mode(mode)
	if mode not in PSIGN: raise ValueError("the half-sky kernels have no '%s' mode" % mode)


def sym_synthesis(A, g, lmax, mode="scalar", lstop=None):
	"""K1: half-sky synthesis. A [nl, nm, C] on the northern rings of g ->
	[nfun, C, 2, nm, nh]: plane 0 is ring t, plane 1 its mirror
	pi - theta_t, from u_f(pi - theta) = PSIGN[f] (-1)^(l+m) u_f(theta).
	lstop, a table of stop degrees per block of the northern rings
	(dead_stops; float32 only on the card), ends the sums of a block and of
	its mirror before its degree: 0 skips the block, whose outputs are 0;
	None runs every block to the end."""
	_check_sym_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "sym_synthesis")
	if not _on_card(A): return PLAIN["sym_synthesis"](A, g, lmax, mode, lstop)
	return _synthesis_launch("sym_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, 2, g.nm, g.nt), lstop)


def full_synthesis(A, g, lmax, mode="scalar", lstop=None, dump_state=False):
	"""K3 (K7 in wigner mode, on a geometry prepared with the spin):
	synthesis on any ring set. A [nl, nm, C] -> [nfun, C, nm, nt]. lstop, a
	table of stop degrees per block (dead_stops, blk_tables; float32 only on
	the card), ends a block's sum before its degree: 0 skips the block,
	whose output is 0; None runs every block to the end. With dump_state
	(float32 Legendre modes, stop degrees multiples of 8) returns (G,
	state): the recurrence state [3, nm, nt] (prev, curr, level) where each
	entry's sum ended."""
	sht_core.check_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "full_synthesis")
	if not _on_card(A): return PLAIN["full_synthesis"](A, g, lmax, mode, lstop, dump_state)
	return _synthesis_launch("full_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, g.nm, g.nt), lstop, dump_state)


def sym_analysis(EO, g, lmax, mode="scalar"):
	"""K2: half-sky analysis. EO [nfun, C, 2, nm, nh] holds E = F_north +
	F_south and O = F_north - F_south on the northern rings of g ->
	[nl, nm, C]; function f of (l, m) takes E where PSIGN[f] (-1)^(l+m) is
	+1 and O where it is -1."""
	_check_sym_mode(mode)
	C = EO.shape[1]
	_check(EO, g, (NFUN[mode], C, 2, g.nm, g.nt), "sym_analysis")
	if not _on_card(EO): return PLAIN["sym_analysis"](EO, g, lmax, mode)
	return _analysis_launch("sym_analysis", EO, g, lmax, mode)


def full_analysis(F, g, lmax, mode="scalar", lstop=None, dump_state=False):
	"""K4 (K7 in wigner mode, on a geometry prepared with the spin): analysis
	on any ring set. F [nfun, C, nm, nt] -> [nl, nm, C]. lstop, a table of
	stop degrees per block (dead_stops, blk_tables; float32 only on the
	card), leaves a block's rings out of every degree from its stop on: 0
	never reads them; None reads all. With dump_state returns (A, state) as full_synthesis does."""
	sht_core.check_mode(mode)
	C = F.shape[1]
	_check(F, g, (NFUN[mode], C, g.nm, g.nt), "full_analysis")
	if not _on_card(F): return PLAIN["full_analysis"](F, g, lmax, mode, lstop, dump_state)
	return _analysis_launch("full_analysis", F, g, lmax, mode, lstop, dump_state)


def _polar_check(x, g, shape, what):
	"""The checks of a near-pole kernel's input x: float64 data and
	geometry, the mode's shape, contiguous."""
	if x.dtype != torch.float64 or g.dtype != torch.float64:
		raise TypeError("%s runs in float64 only, not on %s data and a %s geometry"
			% (what, x.dtype, g.dtype))
	_check(x, g, shape, what)
	if not x.is_contiguous(): raise ValueError("%s: the input must be contiguous" % what)


def polar_analysis(F, g, lmax, mode="scalar"):
	"""K4's float64 near-pole pass, redesigned (csrc/legendre.cu
	polar_analysis_kernel; K7 in wigner mode, on a geometry prepared with the
	spin): analysis in float64 on any ring set, meant for the few rings near
	the poles. F [nfun, C, nm, nt] float64, contiguous -> [nl, nm, C]
	float64. It takes no stop degrees and hands no state over."""
	sht_core.check_mode(mode)
	C = F.shape[1] if F.ndim == 4 else -1
	_polar_check(F, g, (NFUN[mode], C, g.nm, g.nt), "polar_analysis")
	if not _on_card(F): return PLAIN["polar_analysis"](F, g, lmax, mode)
	nl = lmax + 1
	ab, lt, s, _ = _mode_args(g, nl, mode, None, F.device)
	stream = _stream(F)
	out = torch.empty((nl, g.nm, C), dtype=torch.float64, device=F.device)
	for c0, c1 in _col_chunks(C):
		Fc = F if c1 - c0 == C else F[:, c0:c1].contiguous()
		# each launch writes its columns of out, every row of them
		# float64 has no low part of cos theta: the kernel takes none
		_launch("polar_analysis", mode, F.device, True, c1 - c0, Fc.data_ptr(), ab.data_ptr(),
			lt.data_ptr(), g.ct.data_ptr(), g.rows.data_ptr(), g.seed_val.data_ptr(),
			g.seed_level.data_ptr(), out.data_ptr() + c0*out.element_size(), C, nl, g.nm, g.nt, s,
			stream, g.m0)
	return out


def polar_synthesis(A, g, lmax, mode="scalar"):
	"""K3's float64 near-pole pass, redesigned (csrc/legendre.cu
	polar_synthesis_kernel; K7 in wigner mode, on a geometry prepared with
	the spin): synthesis in float64 on any ring set, meant for the few rings
	near the poles. A [nl, nm, C] float64, contiguous -> [nfun, C, nm, nt]
	float64. It takes no stop degrees and hands no state over."""
	sht_core.check_mode(mode)
	C = A.shape[-1] if A.ndim == 3 else -1
	_polar_check(A, g, (lmax + 1, g.nm, C), "polar_synthesis")
	if not _on_card(A): return PLAIN["polar_synthesis"](A, g, lmax, mode)
	nl = lmax + 1
	ab, lt, s, _ = _mode_args(g, nl, mode, None, A.device)
	stream = _stream(A)
	out = torch.empty((NFUN[mode], C, g.nm, g.nt), dtype=torch.float64, device=A.device)
	esize = out.element_size()
	for c0, c1 in _col_chunks(C):
		# each launch reads its columns of A and writes every entry of them in out
		_launch("polar_synthesis", mode, A.device, True, c1 - c0, A.data_ptr() + c0*esize,
			ab.data_ptr(), lt.data_ptr(), g.ct.data_ptr(), g.rows.data_ptr(), g.seed_val.data_ptr(),
			g.seed_level.data_ptr(), out.data_ptr() + c0*g.nm*g.nt*esize, C, C, nl, g.nm, g.nt, s,
			stream, g.m0)
	return out


def _blk_args(x, state, tab, g, nl, mode, what):
	"""The pointers of a block-kernel launch after its checks: the tables
	a, b and the mode's streams, the state, start table, nodes, W in
	fragment order (synthesis, tab.Wfrag) or its TF32 split (analysis,
	tab.Wtf32), cos theta and the ring rows."""
	if mode not in sht_core.BLK_FAM:
		raise ValueError("no block-Legendre kernel in mode '%s'" % mode)
	if g.dtype != torch.float32 or g.s is not None:
		raise TypeError("%s: the block kernels run in float32 Legendre modes only" % what)
	if g.m0: raise NotImplementedError("%s on an m block (m0 = %d)" % (what, g.m0))
	_check(state, g, (3, g.nm, g.nt), what + " state")
	want = (-(-g.nm//BLK_TILE_M), -(-g.nt//BLK_TILE_T))
	if (tab.tile_m, tab.tile_t) != (BLK_TILE_M, BLK_TILE_T) or tuple(tab.start.shape) != want:
		raise ValueError("%s: tables of another tiling or grid" % what)
	if what == "blk_analysis":
		W, wname, wshape = tab.Wtf32, "W's TF32 split (Wtf32)", (2, want[1], BLK_JP, BLK_TILE_T)
	else:
		W, wname, wshape = tab.Wfrag, "W in fragment order (Wfrag)", \
			(want[1], BLK_TILE_T//64, BLK_JP//8, 128, 4)
	if W is None:
		raise ValueError("%s: tables without %s" % (what, wname))
	for t, dt in ((tab.start, torch.int32), (tab.ctv, torch.float32), (tab.W, torch.float32),
			(state, torch.float32), (W, torch.float32)):
		if t.dtype != dt or t.device != x.device or not t.is_contiguous():
			raise ValueError("%s: tables must be contiguous %s tensors on %s" % (what, dt, x.device))
	if tuple(tab.ctv.shape) != (want[1], BLK_JP) or tuple(tab.W.shape) != (want[1], BLK_JP, BLK_TILE_T) \
			or tuple(W.shape) != wshape:
		raise ValueError("%s: node tables of another shape" % what)
	ab = _coef_cached(nl, g.nm, g.dtype, x.device)
	cs = _streams_cached(nl, g.nm, mode, x.device)
	return [ab.data_ptr(), cs.data_ptr(), state.data_ptr(), tab.start.data_ptr(),
		tab.ctv.data_ptr(), W.data_ptr(), g.ct.data_ptr(), g.rows.data_ptr()]


def blk_synthesis(A, state, tab, g, lmax, mode="scalar"):
	"""K8a (scalar) / K8b (deriv, spin1, spin2): the synthesis sum over the
	blocked suffix of every tile that has one, resumed from the state
	full_synthesis dumped. A [nl, nm, C], state [3, nm, nt], tab a
	sht_core.BlkTables -> [nfun, C, nm, nt], zero on tiles without a
	suffix. The kernel's node -> ring product runs in 3xTF32 on the tensor
	cores from tab.Wfrag."""
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "blk_synthesis")
	if not _on_card(A): return PLAIN["blk_synthesis"](A, state, tab, g, lmax, mode)
	ptrs = _blk_args(A, state, tab, g, nl, mode, "blk_synthesis")
	stream = _stream(A)
	outs = []
	for c0, c1 in _col_chunks(C):
		Ac = A[..., c0:c1].contiguous()
		out = torch.zeros((NFUN[mode], c1 - c0, g.nm, g.nt), dtype=g.dtype, device=A.device)
		_launch("blk_synthesis", mode, A.device, False, c1 - c0, Ac.data_ptr(), *ptrs,
			out.data_ptr(), nl, g.nm, g.nt, stream)
		outs.append(out)
	return torch.cat(outs, 1)


def blk_analysis(F, state, tab, g, lmax, mode="scalar"):
	"""K8c (scalar) / K8d (deriv, spin1, spin2): the analysis sums of the
	blocked suffix, resumed from the state full_analysis dumped.
	F [nfun, C, nm, nt] -> [nl, nm, C], zero below every tile's first
	block. The kernel's products run in 3xTF32 from tab.Wtf32."""
	C = F.shape[1]
	nl = lmax + 1
	_check(F, g, (NFUN[mode], C, g.nm, g.nt), "blk_analysis")
	if not _on_card(F): return PLAIN["blk_analysis"](F, state, tab, g, lmax, mode)
	ptrs = _blk_args(F, state, tab, g, nl, mode, "blk_analysis")
	stream = _stream(F)
	nplanes = _planes(-(-g.nt//BLK_TILE_T))
	outs = []
	for c0, c1 in _col_chunks(C):
		Fc = F[:, c0:c1].contiguous()
		part = torch.zeros((nplanes, nl, g.nm, c1 - c0), dtype=g.dtype, device=F.device)
		_launch("blk_analysis", mode, F.device, False, c1 - c0, Fc.data_ptr(), *ptrs,
			part.data_ptr(), nl, g.nm, g.nt, nplanes, stream)
		outs.append(part.sum(0))
	return torch.cat(outs, -1)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def synthesis_scan(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None, *, m0=0):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c] with the recurrence in
	dtype: the plain scan on CPU, the kernels on CUDA. mode "wigner" takes
	the spin s. With m0, on the m block m0 .. mmax: A [nl, mmax + 1 - m0,
	C] holds its columns, and so does the result."""
	if not _on_card(A):
		return sht_core.synthesis(A, geom(theta, mmax, dtype, A.device, s, m0), lmax, mode)
	return kernel_synthesis(A, theta, lmax, mmax, mode, dtype, s, m0=m0)


def analysis_scan(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None, *, m0=0):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t] with the recurrence
	in dtype: the plain scan on CPU, the kernels on CUDA. mode "wigner" takes
	the spin s; m0 as in synthesis_scan."""
	if not _on_card(F):
		return sht_core.analysis(F, geom(theta, mmax, dtype, F.device, s, m0), lmax, mode)
	return kernel_analysis(F, theta, lmax, mmax, mode, dtype, s, m0=m0)


def _polar_split(theta, lmax, mmax, s=None, m0=0):
	"""(nn, ns, Mp, polar theta) of the near-pole pass; in wigner mode its
	m-extent covers the spin (pixell_tpu.ops.sht_pallas._wigner_polar_mmax
	:2142). Mp counts the m block's columns the pass takes: those below the
	pass's m-extent, from the block's first m0."""
	nn, ns = polar_counts(theta, lmax)
	nt = len(theta)
	Mp = min(mmax + 1, POLAR_MMAX if s is None else max(POLAR_MMAX, int(s) + 1))
	return nn, ns, max(Mp - m0, 0), np.concatenate([theta[:nn], theta[nt-ns:]])


def _check_spin(mode, s):
	sht_core.check_mode(mode)
	if (mode == "wigner") != (s is not None):
		raise ValueError("mode '%s' %s a spin s" % (mode, "needs" if s is None else "takes no"))


def kernel_synthesis(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None, *, m0=0):
	"""The kernel dispatch of synthesis_scan (pixell_tpu.ops.sht_pallas.
	synthesis_scan_pallas :498, wigner_synthesis_scan_pallas :2165):
	A [nl, nm, C] -> [nfun, C, nm, nt]; with m0 on the m block m0 .. mmax,
	every launch taking the block's first m. Runs the kernels' plain
	versions on CPU tensors."""
	_check_spin(mode, s)
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _synth_rings(A, theta, lmax, mmax, mode, dtype, s, m0)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax, s, m0)
	if nn + ns >= nt:
		# a ring set that is all near-pole runs entirely in float64
		return _synth_rings(A, theta, lmax, mmax, mode, torch.float64, s, m0).to(dtype)
	G = _synth_rings(A, theta, lmax, mmax, mode, dtype, s, m0)
	if (nn or ns) and Mp:
		# overwrite the near-pole rings, for m < Mp, with a float64 pass: the
		# recurrence amplifies f32 rounding there by ~min(l, 1/theta)^2
		pol = polar_synthesis(A[:, :Mp].to(torch.float64).contiguous(),
			geom(pth, m0 + Mp - 1, torch.float64, A.device, s, m0), lmax, mode).to(dtype)
		G[..., :Mp, :nn] = pol[..., :nn]
		G[..., :Mp, nt-ns:] = pol[..., nn:]
	return G


def _f32_stops(theta, lmax, mmax, dtype, s, device, m0=0):
	"""The dead-tile stops for a K1/K3/K4 launch in dtype: float32 only."""
	if dtype != torch.float32: return None
	return dead_stops(theta, lmax, mmax, 0 if s is None else s, device, m0)


def blk_ok(mode, dtype, lmax, m0=0):
	"""Whether a K3/K4 launch takes the block-Legendre split
	(pixell_tpu.ops.sht_pallas._blk_ok :615): enabled, float32, a Legendre
	mode, lmax >= BLK_MINL. The split does not run on an m block: there it
	raises NotImplementedError."""
	ok = bool(BLK_ENABLE) and dtype == torch.float32 and mode in sht_core.BLK_FAM \
		and lmax >= BLK_MINL
	if ok and m0:
		raise NotImplementedError("sht.blocked() on an m block (m0 = %d)" % m0)
	return ok


def blocked_synthesis(A, theta, lmax, mmax, mode="scalar"):
	"""K3 up to each tile's handoff degree, then the block kernel over the
	suffix, in float32: A [nl, nm, C] -> [nfun, C, nm, nt]
	(pixell_tpu.ops.sht_pallas._synthesis_scan_pallas_blocked :1178). Plain
	K3 with the dead-tile stops where no tile has a suffix."""
	dt = torch.float32
	A = A.to(dt).contiguous()
	g = geom(theta, mmax, dt, A.device)
	split = blk_tables(theta, lmax, mmax, A.device)
	if split is None:
		return full_synthesis(A, g, lmax, mode, _f32_stops(theta, lmax, mmax, dt, None, A.device))
	tab, lstop = split
	G, state = full_synthesis(A, g, lmax, mode, lstop, dump_state=True)
	return G + blk_synthesis(A, state, tab, g, lmax, mode)


def blocked_analysis(F, theta, lmax, mmax, mode="scalar"):
	"""K4 up to each tile's handoff degree, then the block kernel over the
	suffix, in float32: F [nfun, C, nm, nt] -> [nl, nm, C]
	(pixell_tpu.ops.sht_pallas._analysis_scan_pallas_blocked :1491)."""
	dt = torch.float32
	F = F.to(dt).contiguous()
	g = geom(theta, mmax, dt, F.device)
	split = blk_tables(theta, lmax, mmax, F.device)
	if split is None:
		return full_analysis(F, g, lmax, mode, _f32_stops(theta, lmax, mmax, dt, None, F.device))
	tab, lstop = split
	out, state = full_analysis(F, g, lmax, mode, lstop, dump_state=True)
	return out + blk_analysis(F, state, tab, g, lmax, mode)


def _synth_rings(A, theta, lmax, mmax, mode, dtype, s=None, m0=0):
	"""[nfun, C, nm, nt] through K1 (symmetric ring set, Legendre modes) or K3,
	split with the block kernel where blk_ok."""
	A = A.to(dtype).contiguous()
	nt = len(theta)
	nh = None if mode == "wigner" else detect_sym(theta)
	if nh is None:
		if blk_ok(mode, dtype, lmax, m0): return blocked_synthesis(A, theta, lmax, mmax, mode)
		return full_synthesis(A, geom(theta, mmax, dtype, A.device, s, m0), lmax, mode,
			_f32_stops(theta, lmax, mmax, dtype, s, A.device, m0))
	north = theta[:nh]
	pair = sym_synthesis(A, geom(north, mmax, dtype, A.device, m0=m0), lmax, mode,
		_f32_stops(north, lmax, mmax, dtype, None, A.device, m0))
	return torch.cat([pair[:, :, 0], pair[:, :, 1, :, :nt - nh].flip(-1)], -1)


def kernel_analysis(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None, *, m0=0):
	"""The kernel dispatch of analysis_scan (pixell_tpu.ops.sht_pallas.
	analysis_scan_pallas_chunked :2108 with _maybe_polar_analysis :1797,
	wigner_analysis_scan_pallas :2221): F [nfun, C, nm, nt] -> [nl, nm, C];
	with m0 on the m block m0 .. mmax, as kernel_synthesis. Runs the
	kernels' plain versions on CPU tensors."""
	_check_spin(mode, s)
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _anal_rings(F, theta, lmax, mmax, mode, dtype, s, m0)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax, s, m0)
	if nn + ns >= nt:
		return _anal_rings(F, theta, lmax, mmax, mode, torch.float64, s, m0).to(dtype)
	if not (nn or ns):
		return _anal_rings(F, theta, lmax, mmax, mode, dtype, s, m0)
	out = _anal_rings(F[..., nn:nt-ns], theta[nn:nt-ns], lmax, mmax, mode, dtype, s, m0)
	if not Mp: return out
	# near-pole rings contribute through a float64 pass, for m < Mp
	Fp = torch.cat([F[..., :nn], F[..., nt-ns:]], -1)[..., :Mp, :]
	pol = polar_analysis(Fp.to(torch.float64).contiguous(),
		geom(pth, m0 + Mp - 1, torch.float64, F.device, s, m0), lmax, mode)
	out[:, :Mp] += pol.to(dtype)
	return out


def _anal_rings(F, theta, lmax, mmax, mode, dtype, s=None, m0=0):
	"""[nl, nm, C] through K2 (symmetric ring set, Legendre modes) or K4, in
	chunks of TCHUNK rings (pixell_tpu.ops.sht_pallas._analysis_sym_entry
	:1825, _wigner_anal_full :2195)."""
	F = F.to(dtype)
	nt = F.shape[-1]
	nh = None if mode == "wigner" else detect_sym(theta)
	if nh is not None:
		# even/odd hemisphere combinations on the northern rings
		south = F[..., nh:].flip(-1)
		if nt - nh < nh:   # odd nt: the middle ring pairs with itself
			south = torch.nn.functional.pad(south, (0, nh - (nt - nh)))
		north = F[..., :nh]
		F, theta = torch.stack([north + south, north - south], 2), theta[:nh]
	out = None
	for i0 in range(0, len(theta), TCHUNK):
		i1 = min(i0 + TCHUNK, len(theta))
		Fc, th = F[..., i0:i1].contiguous(), theta[i0:i1]
		if nh is not None:
			part = sym_analysis(Fc, geom(th, mmax, dtype, F.device, m0=m0), lmax, mode)
		elif blk_ok(mode, dtype, lmax, m0):
			part = blocked_analysis(Fc, th, lmax, mmax, mode)
		else:
			part = full_analysis(Fc, geom(th, mmax, dtype, F.device, s, m0), lmax, mode,
				_f32_stops(th, lmax, mmax, dtype, s, F.device, m0))
		out = part if out is None else out + part
	return out
