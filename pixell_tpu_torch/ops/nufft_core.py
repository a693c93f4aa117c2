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
"""
from __future__ import annotations
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
