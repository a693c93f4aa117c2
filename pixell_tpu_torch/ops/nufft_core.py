"""The NUFFT point stage in plain PyTorch: the twins of the kernels in
csrc/nufft.cu (counterparts of pixell_tpu/fft.py _u2nu_2d_core_split :391,
_u2nu_2d_core :379 and _nu2u_2d_core :610).

A point with coordinates (cy, cx) in units of the periods (pery, perx) sits
at the fine-grid position py = ((cy/pery) mod 1) nfy, likewise px. The
position is computed in float64 whatever the working dtype and split into
an integer base floor(py) and a fraction fy = py - floor(py), and only the
fraction is cast to the working dtype: one float32 position on an
8064-wide grid would quantize to ~5e-4 pixels (pixell_tpu/fft.py:393-397).
The point's w taps in y are the rows floor(py) + ty + 1 + j, j < w, with
ty = floor(fy - w/2), wrapped periodically, each weighted by the
exponential-of-semicircle (ES) kernel at z = (fy - (ty + 1 + j))/(w/2);
likewise in x. The kernels do the same arithmetic in the same order, so
the positions and weights are the same numbers on the card.

u2nu_points_plain gathers each point's w x w window, nu2u_spread_plain
spreads onto it (its transpose). Both work through the points in chunks:
unchunked, the gathered windows of a million-point set take gigabytes
(pixell_tpu/fft.py:336-341).

bin_points sorts the points by the fine-grid tile that holds their first
tap, for the kernels, which take one tile's points in a block with the tile
and its halo in shared memory.
"""
from __future__ import annotations
from typing import NamedTuple
import torch

GATHER_ELEMS = 1 << 24   # gathered (component, point, tap) values per chunk


def es_kernel(z, beta):
	"""phi(z) = exp(beta (sqrt(1 - z^2) - 1)) for |z| <= 1, else 0
	(pixell_tpu.fft._es_kernel :306)."""
	z2 = torch.clamp(z*z, 0, 1)
	return torch.where(z.abs() <= 1, torch.exp(beta*(torch.sqrt(1 - z2) - 1)),
		torch.zeros((), dtype=z.dtype, device=z.device))


def split_positions(coords, nfine, periodicity):
	"""coords [npt, 2] float64 -> [(base, fraction)] for y and x: the
	int64 base floor(p) and the float64 fraction p - floor(p) of the
	fine-grid position p = ((c/per) mod 1) n."""
	out = []
	for a in range(2):
		p = torch.remainder(coords[:, a]/float(periodicity[a]), 1.0)*float(nfine[a])
		b = torch.floor(p)
		out.append((b.long(), p - b))
	return out


def taps(base, frac, w, beta, n, dtype):
	"""(indices [npt, w] int64 into an axis of length n, weights [npt, w]
	dtype) of points at base + frac."""
	f = frac.to(dtype)
	hw = w/2.0
	t = torch.floor(f - hw)
	offs = torch.arange(w, dtype=dtype, device=f.device)
	wt = es_kernel((f[:, None] - (t[:, None] + 1 + offs))/hw, beta)
	idx = base[:, None] + t.long()[:, None] + 1 + torch.arange(w, device=f.device)
	return torch.remainder(idx, n), wt


def _chunks(npt, C, w, r):
	step = max(1, GATHER_ELEMS//(C*w*w*r))
	return [(p0, min(p0 + step, npt)) for p0 in range(0, npt, step)]


def _windows(pos, p0, p1, nfine, w, beta, dtype):
	"""(flat indices [p*w*w] of the points' windows, wy [p, w], wx [p, w])."""
	(by, fy), (bx, fx) = pos
	iy, wy = taps(by[p0:p1], fy[p0:p1], w, beta, nfine[0], dtype)
	ix, wx = taps(bx[p0:p1], fx[p0:p1], w, beta, nfine[1], dtype)
	return (iy[:, :, None]*nfine[1] + ix[:, None, :]).reshape(-1), wy, wx


def u2nu_points_plain(fine, coords, periodicity, w, beta):
	"""fine [C, nfy, nfx] (real or complex), coords [npt, 2] float64 ->
	[C, npt]: each point's ES-weighted sum over its w x w window."""
	C, nfy, nfx = fine.shape
	cplx = fine.is_complex()
	rdt = fine.real.dtype if cplx else fine.dtype
	flat = fine.reshape(C, nfy*nfx)
	fr = torch.view_as_real(flat) if cplx else flat[..., None]        # [C, N, r]
	pos = split_positions(coords, (nfy, nfx), periodicity)
	outs = []
	for p0, p1 in _chunks(coords.shape[0], C, w, fr.shape[-1]):
		idx, wy, wx = _windows(pos, p0, p1, (nfy, nfx), w, beta, rdt)
		vals = fr[:, idx].reshape(C, p1 - p0, w, w, fr.shape[-1])
		outs.append(torch.einsum("cpyxr,py,px->cpr", vals, wy, wx))
	res = torch.cat(outs, 1) if outs else fr.new_zeros((C, 0, fr.shape[-1]))
	return torch.view_as_complex(res.contiguous()) if cplx else res[..., 0]


def nu2u_spread_plain(vals, coords, nfine, periodicity, w, beta):
	"""vals [C, npt] (real or complex), coords [npt, 2] float64 -> the fine
	grid [C, nfy, nfx] of vals' kind: the transpose of u2nu_points_plain,
	each point's value times its window's weights added onto the window."""
	C, npt = vals.shape
	nfy, nfx = int(nfine[0]), int(nfine[1])
	cplx = vals.is_complex()
	rdt = vals.real.dtype if cplx else vals.dtype
	vr = torch.view_as_real(vals) if cplx else vals[..., None]          # [C, npt, r]
	r = vr.shape[-1]
	fine = vr.new_zeros((C, nfy*nfx, r))
	pos = split_positions(coords, (nfy, nfx), periodicity)
	for p0, p1 in _chunks(npt, C, w, r):
		idx, wy, wx = _windows(pos, p0, p1, (nfy, nfx), w, beta, rdt)
		contrib = torch.einsum("cpr,py,px->cpyxr", vr[:, p0:p1], wy, wx)
		fine.index_add_(1, idx, contrib.reshape(C, -1, r))
	fine = fine.reshape(C, nfy, nfx, r)
	return torch.view_as_complex(fine) if cplx else fine[..., 0]


class Bins(NamedTuple):
	"""The points binned by tile (bin_points).

	perm    [npt] int64: the points in binned order (point perm[k] is the
	        k-th), stable: sorted by tile, ties in the original order
	subs    [nsub_max, 3] int64: per subproblem (tile, start, end), the
	        points perm[start:end], at most cap of them, all of one tile;
	        the entries past the last subproblem are empty (start = end = npt)
	counts  [ntiles] int64: the points of each tile, tiles in row-major order
	ntiles  (nty, ntx)
	"""
	perm: torch.Tensor
	subs: torch.Tensor
	counts: torch.Tensor
	ntiles: tuple


def first_taps(coords, nfine, periodicity, w, dtype):
	"""[npt, 2] int64: each point's first tap (row, column), wrapped, as
	taps places it (base + floor(f - w/2) + 1, the fraction f cast to dtype)
	and with the kernels' arithmetic, in float64 throughout: c/per by a true
	division (a tensor divisor: a CUDA tensor divided by a Python float is
	multiplied by its reciprocal), minus its floor, times n."""
	dev = coords.device
	t = coords/torch.tensor([float(periodicity[0]), float(periodicity[1])], dtype=torch.float64,
		device=dev)
	t.sub_(torch.floor(t))
	t.mul_(torch.tensor([float(nfine[0]), float(nfine[1])], dtype=torch.float64, device=dev))
	b = torch.floor(t)
	f = t.sub_(b).to(dtype)
	first = b.add_(torch.floor(f.sub_(w/2.0))).add_(1).long()
	return torch.remainder(first, torch.tensor([int(nfine[0]), int(nfine[1])], device=dev))


def key_format(ntiles):
	"""(dtype, offset) of the tile keys: int16 holding tile - 32768 where
	there are at most 65536 tiles (half the bytes to sort, in the same
	order), else int32 holding the tile."""
	return (torch.int16, 32768) if ntiles <= 1 << 16 else (torch.int32, 0)


def tile_keys(coords, nfine, periodicity, w, dtype, tile):
	"""[npt] the key of each point for bin_points: the tile (tile = (Ty,
	Tx) fine cells, nty = ceil(nfy/Ty) by ntx tiles in row-major order)
	that holds its first tap (first_taps), in key_format; the plain twin of
	K12 (csrc/nufft.cu tile_keys_kernel)."""
	ty, tx = int(tile[0]), int(tile[1])
	nty, ntx = -(-int(nfine[0])//ty), -(-int(nfine[1])//tx)
	dt, offset = key_format(nty*ntx)
	first = first_taps(coords, nfine, periodicity, w, dtype)
	return ((first[:, 0]//ty)*ntx + first[:, 1]//tx - offset).to(dt)


def bin_points(coords, nfine, periodicity, w, dtype, tile, cap, keys=None):
	"""Bins (above) of the points coords [npt, 2] float64 on a fine grid
	nfine = (nfy, nfx): each point goes to the tile (tile = (Ty, Tx) fine
	cells; nty = ceil(nfy/Ty) by ntx tiles, the last row and column of
	tiles ragged) that holds its first tap, so that the padded tile of (Ty +
	w - 1) x (Tx + w - 1) cells from the tile's corner, wrapped, holds every
	tap of every point of the tile. Each tile's points are split into
	subproblems of at most cap. keys, the points' tile_keys, are computed
	here unless given (the card's wrappers give K12's). Torch operations
	with no host synchronisation: nsub_max = npt // cap + min(nty ntx, npt)
	bounds the subproblem count."""
	ty, tx = int(tile[0]), int(tile[1])
	nty, ntx = -(-int(nfine[0])//ty), -(-int(nfine[1])//tx)
	nt = nty*ntx
	npt = coords.shape[0]
	dev = coords.device
	if keys is None: keys = tile_keys(coords, nfine, periodicity, w, dtype, tile)
	skey, perm = torch.sort(keys, stable=True)
	# each tile's range in the sorted order
	offset = key_format(nt)[1]
	first = torch.searchsorted(skey, (torch.arange(nt, device=dev) - offset).to(skey.dtype))
	edges = torch.cat([first, torch.full((1,), npt, dtype=first.dtype, device=dev)])
	counts = edges[1:] - edges[:-1]
	nsub = (counts + cap - 1)//cap
	last = torch.cumsum(nsub, 0)
	s = torch.arange(npt//cap + min(nt, npt), device=dev)
	t = torch.searchsorted(last, s, right=True)
	tc = t.clamp(max=nt - 1)
	start = edges[tc] + (s - (last[tc] - nsub[tc]))*cap
	end = torch.minimum(start + cap, edges[tc + 1])
	past = t >= nt
	start = torch.where(past, npt, start)
	end = torch.where(past, npt, end)
	return Bins(perm, torch.stack([tc, start, end], 1).contiguous(), counts, (nty, ntx))
