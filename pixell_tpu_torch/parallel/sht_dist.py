"""Multi-device spherical harmonic transforms (counterpart of
pixell_tpu/parallel/sht_dist.py).

Ring sharding: the Legendre stage is elementwise in theta and each ring's
FFT is local, so synthesis needs no communication (alm replicated, map
sharded over rings) and analysis one all-reduce of each rank's partial alm.
A rank's ring block is not north/south symmetric, so the dispatch gives it
K3/K4 where the whole ring set would take K1/K2, and only the ranks that
hold near-pole rings run the float64 near-pole pass.

m sharding: the alm lives in the rectangular representation rect [ncomp,
nl, nm], sharded over its m axis. The Legendre stage is elementwise in m,
so each rank runs its contiguous m block through K1-K4 (every launch takes
the block's first m) and the harmonic side's memory shrinks with the mesh;
the only communication is one all-to-all between the m-sharded phases and
the ring-sharded ring FFTs.

The carrier is DTensor: a row-sharded map is Shard(ndim - 2) on "rows",
replicated alm Replicate(), an m-sharded rect Shard(ndim - 1) on the m
axis, and the reference's resharding (with_sharding_constraint from rings
to m) a redistribute. Each function takes a DTensor or a tensor every rank
holds whole, and returns a DTensor; full() (or DTensor.full_tensor())
gathers it. Complex DTensors move through their real views, which every
backend's collectives take. Each shard_map
body of the reference is one of the _local functions below, which run one
rank's work given its index, so that a single process can run the ranks in
turn. Everything of the reference's sht_dist is ported.
"""
from __future__ import annotations
import numpy as np
import torch
import torch.distributed as tdist
from .. import sht
from .mesh import placements, axis_size, block

_RDT = {torch.float32: torch.float32, torch.float64: torch.float64,
	torch.complex64: torch.float32, torch.complex128: torch.float64}


def _contiguous_stride(shape):
	stride, acc = [], 1
	for n in reversed(shape):
		stride.append(acc); acc *= int(n)
	return tuple(reversed(stride))


def _dtensor(local, mesh, dims, shape):
	"""The DTensor of global shape shape whose rank-local part is local,
	sharded on the dimensions dims ({axis name: dimension}) and replicated
	over the other mesh axes."""
	from torch.distributed.tensor import DTensor
	shape = tuple(int(n) for n in shape)
	return DTensor.from_local(local, mesh, placements(mesh, dims), run_check=False, shape=shape,
		stride=_contiguous_stride(shape))


def _as_real(x):
	"""A complex DTensor as the DTensor of its real view (a trailing axis of
	2): its collectives then move real numbers, which every backend takes."""
	from torch.distributed.tensor import DTensor
	shape = tuple(x.shape) + (2,)
	return DTensor.from_local(torch.view_as_real(x.to_local().contiguous()), x.device_mesh, x.placements,
		run_check=False, shape=shape, stride=_contiguous_stride(shape))


def _local(x, mesh, dims):
	"""This rank's part of x under the sharding dims: a DTensor's local part
	(redistributed first if it is sharded otherwise), or the chunks of a
	tensor every rank holds whole."""
	from torch.distributed.tensor import DTensor
	if isinstance(x, DTensor):
		want = placements(mesh, dims)
		if list(x.placements) == want: return x.to_local()
		if x.is_complex():
			return torch.view_as_complex(_as_real(x).redistribute(mesh, want).to_local().contiguous())
		return x.redistribute(mesh, want).to_local()
	for axis, d in dims.items():
		size, idx = axis_size(mesh, axis)
		i0, i1 = block(x.shape[d], size, idx)
		x = x.narrow(d, i0, i1 - i0)
	return x


def full(x):
	"""The whole tensor of x on every rank: a DTensor gathered (a complex one
	through its real view), any other tensor as it is."""
	from torch.distributed.tensor import DTensor
	if not isinstance(x, DTensor): return x
	if x.is_complex(): return torch.view_as_complex(_as_real(x).full_tensor().contiguous())
	return x.full_tensor()


def _psum(a, mesh, axis):
	"""The all-reduce over the mesh axis axis (the reference's psum): gloo and
	NCCL both sum complex tensors."""
	tdist.all_reduce(a, group=mesh.get_group(axis))
	return a


# ---------------------------------------------------------------------------
# Ring sharding
# ---------------------------------------------------------------------------
def _synthesis_local(alm, theta, nphi, rank, size, phi0=0.0, lmax=None, mmax=None, spin=(0, 2),
		deriv=False, map_dtype=None):
	"""Rank rank of size's synthesis: its ring block of sht.synthesis."""
	t0, t1 = block(len(theta), size, rank)
	th = np.asarray(theta, np.float64)[t0:t1]
	if map_dtype is None: map_dtype = _RDT[alm.dtype]
	if t1 == t0:
		pre = (2,) if deriv else alm.shape[:-1]
		return torch.zeros(pre + (0, nphi), dtype=map_dtype, device=alm.device)
	return sht.synthesis(alm, th, nphi, phi0=phi0, lmax=lmax, mmax=mmax, spin=spin, deriv=deriv,
		map_dtype=map_dtype)


def _analysis_local(maps, theta, weights, rank, size, lmax, mmax=None, phi0=0.0, spin=(0, 2),
		deriv=False):
	"""Rank rank of size's partial alm from its rows maps of the ring block:
	sht.analysis with its weights, or without weights the adjoint of
	synthesis. The partial alm of all ranks sum to the whole transform's."""
	t0, t1 = block(len(theta), size, rank)
	th = np.asarray(theta, np.float64)[t0:t1]
	if weights is None:
		return sht.adjoint_synthesis(maps, th, lmax, mmax=mmax, phi0=phi0, spin=spin, deriv=deriv)
	w = np.asarray(weights.cpu() if torch.is_tensor(weights) else weights, np.float64)[t0:t1]
	return sht.analysis(maps, th, lmax, w, mmax=mmax, phi0=phi0, spin=spin, deriv=deriv)


def synthesis_dist(alm, theta, nphi, mesh, phi0=0.0, lmax=None, mmax=None, spin=(0, 2),
		deriv=False, map_dtype=None, row_axis="rows"):
	"""Ring-sharded synthesis (pixell_tpu.parallel.sht_dist.synthesis_dist
	:34): alm [ncomp, nalm] (replicated) -> map [ncomp, nt, nphi] sharded
	over rings, with no collective. deriv=True takes alm [nalm] and gives
	[2, nt, nphi] (d/dtheta, d/dphi) as sht.synthesis does."""
	alm = full(alm)
	size, rank = axis_size(mesh, row_axis)
	loc = _synthesis_local(alm, theta, nphi, rank, size, phi0, lmax, mmax, tuple(np.atleast_1d(spin)),
		deriv, map_dtype)
	shape = loc.shape[:-2] + (len(theta), nphi)
	return _dtensor(loc.contiguous(), mesh, {row_axis: loc.ndim - 2}, shape)


def analysis_dist(maps, theta, weights, mesh, lmax, mmax=None, phi0=0.0, spin=(0, 2), deriv=False,
		row_axis="rows"):
	"""Ring-sharded analysis (pixell_tpu.parallel.sht_dist.analysis_dist
	:59): a map sharded over rings (a DTensor, or a tensor every rank holds
	whole) -> alm, replicated, with one all-reduce of the ranks' partial alm
	over the row axis. weights=None gives the adjoint of synthesis."""
	nd = maps.ndim
	loc = _local(maps, mesh, {row_axis: nd - 2})
	size, rank = axis_size(mesh, row_axis)
	a = _analysis_local(loc, theta, weights, rank, size, lmax, mmax, phi0, tuple(np.atleast_1d(spin)),
		deriv)
	a = _psum(a.contiguous(), mesh, row_axis)
	return _dtensor(a, mesh, {}, a.shape)


# ---------------------------------------------------------------------------
# m sharding
# ---------------------------------------------------------------------------
def _pad_mmax(lmax, mmax, size):
	"""The m-sharded path runs at the smallest mmax with (mmax + 1) % size
	== 0, so that every rank's m block has the same width (the reference's
	_pad_mmax :125, which GSPMD needs; here it keeps the all-to-all even).
	The extra columns are exact zeros: the seed of a row m > lmax lies past
	lmax."""
	return -(-(mmax + 1)//size)*size - 1


def _synthesis_m_local(rect, theta, lmax, m0, spin=(0, 2)):
	"""One rank's Legendre stage of the m-sharded synthesis: its rect block
	[ncomp, nl, nb] of the columns m0 .. m0 + nb - 1 -> its phases [ncomp,
	nb, nt] on every ring, through K1-K4 with the block's first m."""
	return sht.synthesis_rect_phase(rect, theta, lmax, m0 + rect.shape[-1] - 1, spin, m0=m0)


def _analysis_m_local(F, theta, lmax, weights, nphi, m0, mmax, spin=(0, 2)):
	"""One rank's quadrature analysis of the m-sharded path: its phases F
	[ncomp, nb, nt] of the columns m0 .. m0 + nb - 1 (every ring) -> its
	rect block [ncomp, nl, nb], the columns past mmax zeroed."""
	nb = F.shape[-2]
	rect = sht.analysis_phase(F, theta, lmax, weights, nphi, mmax=m0 + nb - 1, spin=spin, m0=m0,
		rect_out=True)
	if m0 + nb - 1 > mmax:
		keep = torch.arange(m0, m0 + nb, device=rect.device) <= mmax
		rect = torch.where(keep, rect, torch.zeros((), dtype=rect.dtype, device=rect.device))
	return rect


def synthesis_dist_m(rect, theta, nphi, mesh, phi0=0.0, lmax=None, mmax=None, spin=(0, 2),
		m_axis="cols", row_axis="rows"):
	"""m-sharded synthesis (pixell_tpu.parallel.sht_dist.synthesis_dist_m
	:135): rect [ncomp, nl, nm] sharded over m (a DTensor, or a tensor every
	rank holds whole) -> map [ncomp, nt, nphi] sharded over rings. Each rank
	runs its m block through the Legendre stage, one all-to-all takes the
	phases from m sharding to ring sharding, and each rank's ring FFTs make
	its rows."""
	from torch.distributed.tensor import DTensor
	gshape = rect.shape
	if lmax is None: lmax = gshape[-2] - 1
	if mmax is None: mmax = gshape[-1] - 1
	msize, mrank = axis_size(mesh, m_axis)
	mpad = _pad_mmax(lmax, mmax, msize)
	if not isinstance(rect, DTensor) and mpad + 1 > gshape[-1]:
		rect = torch.nn.functional.pad(rect, (0, mpad + 1 - gshape[-1]))
	loc = _local(rect, mesh, {m_axis: 2})
	m0 = block(mpad + 1, msize, mrank)[0]
	G = _synthesis_m_local(loc, theta, lmax, m0, tuple(np.atleast_1d(spin)))
	nt = len(theta)
	Gd = _dtensor(G.contiguous(), mesh, {m_axis: 1}, (G.shape[0], mpad + 1, nt))
	Gr = _local(Gd, mesh, {row_axis: 2})            # the all-to-all: m -> rings
	out = sht.ring_synthesis(Gr, phi0, nphi).to(_RDT[G.dtype])
	return _dtensor(out.contiguous(), mesh, {row_axis: 1}, (G.shape[0], nt, nphi))


def analysis_dist_m(maps, theta, weights, mesh, lmax, mmax=None, phi0=0.0, spin=(0, 2),
		m_axis="cols", row_axis="rows"):
	"""m-sharded analysis (pixell_tpu.parallel.sht_dist.analysis_dist_m
	:158): a ring-sharded map [ncomp, nt, nphi] -> rect [ncomp, nl, nm]
	sharded over m, nm padded up to a multiple of the m axis (the pad
	columns zeroed). The ring FFTs are rank-local, one all-to-all takes the
	phases to m sharding, and each rank's quadrature and Legendre transpose
	give its m block: a rank holds nl nm / size of the alm."""
	if mmax is None: mmax = lmax
	msize, mrank = axis_size(mesh, m_axis)
	mpad = _pad_mmax(lmax, mmax, msize)
	nt, nphi = len(theta), maps.shape[-1]
	loc = _local(maps, mesh, {row_axis: maps.ndim - 2})
	F = sht.ring_analysis(loc, phi0, mpad + 1)                        # [ncomp, nm, nt_local]
	Fd = _dtensor(F.contiguous(), mesh, {row_axis: 2}, (F.shape[0], mpad + 1, nt))
	Fm = _local(Fd, mesh, {m_axis: 1})                                 # the all-to-all: rings -> m
	m0 = block(mpad + 1, msize, mrank)[0]
	rect = _analysis_m_local(Fm, theta, lmax, weights, nphi, m0, mmax, tuple(np.atleast_1d(spin)))
	return _dtensor(rect.contiguous(), mesh, {m_axis: 2}, (rect.shape[0], lmax + 1, mpad + 1))


def roundtrip_step(mesh, lmax, variant="F1", nphi=None, ncomp=3, spin=(0, 2), dtype=np.float64,
		row_axis="rows", shard="rings"):
	"""A full SHT roundtrip step (map2alm -> per-l filter -> alm2map), the
	library's step (pixell_tpu.parallel.sht_dist.roundtrip_step :162):
	returns (step, (nt, nphi)), with step(maps) -> (omap, alm) as DTensors.
	shard="rings": ring-sharded transforms with one all-reduce, the alm
	replicated. shard="m": m-sharded transforms; the harmonic side stays
	sharded over the mesh's m axis ("cols" where the mesh has one, else
	row_axis) end to end, the filter applied to each rank's rect block."""
	nt = 2*lmax + 2
	if nphi is None: nphi = 2*lmax + 4
	theta = sht.ring_theta(variant, nt)
	weights = sht.ring_weights(variant, nt)
	l = np.arange(lmax + 1)
	fl_host = np.exp(-0.5*l*(l + 1)*0.01**2)
	if shard == "m":
		m_axis = "cols" if "cols" in mesh.mesh_dim_names else row_axis
		def step(maps):
			rect = analysis_dist_m(maps, theta, weights, mesh, lmax, spin=spin, m_axis=m_axis,
				row_axis=row_axis)
			loc = rect.to_local()
			fl = torch.as_tensor(fl_host, dtype=_RDT[loc.dtype], device=loc.device)
			rect = _dtensor(loc*fl[:, None], mesh, {m_axis: 2}, rect.shape)   # per-l filter, m-local
			omap = synthesis_dist_m(rect, theta, nphi, mesh, lmax=lmax, spin=spin, m_axis=m_axis,
				row_axis=row_axis)
			return omap, rect
		return step, (nt, nphi)
	from .. import curvedsky
	def step(maps):
		alm = analysis_dist(maps, theta, weights, mesh, lmax, spin=spin, row_axis=row_axis)
		a = curvedsky.almxfl(alm.to_local(), fl_host, ainfo=curvedsky.alm_info(lmax=lmax))
		alm = _dtensor(a, mesh, {}, a.shape)
		omap = synthesis_dist(a, theta, nphi, mesh, lmax=lmax, spin=spin, row_axis=row_axis)
		return omap, alm
	return step, (nt, nphi)
