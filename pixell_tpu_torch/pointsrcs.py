"""Point-source and object simulation and photometry (counterpart of
pixell_tpu/pointsrcs.py).

The painting follows the reference's cell decomposition: the map is cut
into cells of CSIZE x CSIZE pixels, and the host (numpy) assigns each
object to the cells its own truncation radius reaches, as a table
[ncell_active, K] padded with -1 (K a power of two). The paint then runs in
plain torch on the map's device: the active cells are gathered from a view
of the map, each of the K slots evaluates its object's profile at every
pixel of every active cell (exact angular distance, linear interpolation on
an equispaced radius grid), and the cells are written back. The adjoint
(transpose=True) sums the map against each slot's profile and accumulates
per object with index_add_. Cells are processed in chunks of at most
PAINT_CHUNK pixels. radial_sum gathers each object's (2R+1)^2 window in
batches of objects (RADIAL_CHUNK window pixels a batch) and bins it with
one scatter_add.

Results stay on the map's device: the transpose's amplitudes and
radial_sum's sums are tensors there. Maps are made on device="cuda" unless
told otherwise (or omap's). The catalogues are host numpy, in every
format: text, HDF5 and the FITS binary tables (generic, nemo, dory,
sauron), through fits_io. sim_srcs_dist_transform runs on the distance
kernels (K13 / K14).
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, utils, wcsutils, fits_io, bunch as _bunch
from .bunch import Bunch


def expand_beam(beam, nsamp=10000, rmax=None, tol=1e-7):
	"""A beam spec as (r, br) arrays: a scalar is a Gaussian sigma (radians),
	else an (r, br) pair or a [2, n] / [n, 2] array."""
	if np.isscalar(beam) or np.ndim(beam) == 0:
		sigma = float(beam)
		if rmax is None: rmax = sigma*nsigma2rmax(1.0, tol)
		r = np.linspace(0, rmax, nsamp)
		return np.array([r, np.exp(-0.5*(r/sigma)**2)])
	beam = np.asarray(beam)
	if beam.ndim == 1:
		r = np.linspace(0, rmax if rmax else 5*utils.degree, len(beam))
		return np.array([r, beam])
	if beam.shape[0] != 2: beam = beam.T
	return beam

def nsigma2rmax(sigma, tol=1e-7):
	"""The radius in sigmas where a Gaussian falls to tol."""
	return np.sqrt(-2*np.log(tol))

def _profile_rmax(prof, vmin):
	r, br = prof
	above = np.where(np.abs(br) >= vmin)[0]
	return r[above[-1]] if len(above) else r[-1]


CSIZE = 32          # cell size in pixels
PAINT_CHUNK = 1 << 24   # pixels of active cells painted at a time
RADIAL_CHUNK = 1 << 24  # window pixels of radial_sum's objects binned at a time


def _build_cells(pix, Ry, Rx, ny, nx, csize, wrapx):
	"""The cell assignment on the host: for each object the cells its pixel
	radius (Ry, Rx) reaches; (cell_ids[nact], cell_src[nact, K]) with -1
	padding, K a power of two."""
	ncy, ncx = -(-ny//csize), -(-nx//csize)
	y, x = pix[0], pix[1]
	cy0 = np.clip((y - Ry)//csize, 0, ncy-1)
	cy1 = np.clip((y + Ry)//csize, 0, ncy-1)
	alive = (y + Ry >= 0) & (y - Ry < ny)
	if wrapx:
		x = x % nx
		xc0 = (x - Rx)//csize            # may be negative: wraps
		nxc = np.minimum((x + Rx)//csize - xc0 + 1, ncx)
	else:
		xc0 = np.clip((x - Rx)//csize, 0, ncx-1)
		nxc = np.clip((x + Rx)//csize, 0, ncx-1) - xc0 + 1
		alive &= (x + Rx >= 0) & (x - Rx < nx)
	nyc = np.where(alive, cy1 - cy0 + 1, 0)
	nxc = np.where(alive, nxc, 1)
	cnt = nyc*nxc
	tot = int(cnt.sum())
	if tot == 0:
		return (np.zeros(0, np.int32), np.zeros((0, 1), np.int32))
	src = np.repeat(np.arange(len(y)), cnt)
	k = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
	ky, kx = k // nxc[src], k % nxc[src]
	cy = cy0[src] + ky
	cx = (xc0[src] + kx) % ncx if wrapx else xc0[src] + kx
	cell = (cy*ncx + cx).astype(np.int64)
	order = np.argsort(cell, kind="stable")
	cell_s, src_s = cell[order], src[order].astype(np.int32)
	ucell, start, ccount = np.unique(cell_s, return_index=True, return_counts=True)
	K = 1 << int(np.ceil(np.log2(max(int(ccount.max()), 1))))
	cell_src = np.full((len(ucell), K), -1, np.int32)
	rowpos = np.arange(tot) - np.repeat(start, ccount)
	cell_src[np.repeat(np.arange(len(ucell)), ccount), rowpos] = src_s
	return ucell.astype(np.int32), cell_src


def _angdist(ra1, dec1, ra2, dec2):
	"""Vincenty's angular distance, broadcasting its four tensors."""
	dra = ra2 - ra1
	c1, s1, c2, s2 = torch.cos(dec1), torch.sin(dec1), torch.cos(dec2), torch.sin(dec2)
	cd = torch.cos(dra)
	y = torch.hypot(c2*torch.sin(dra), c1*s2 - s1*c2*cd)
	return torch.atan2(y, s1*s2 + c1*c2*cd)


def _paint_cells(mflat, cell_ids, cell_src, amps, prof_b, prof_dr, prof_ids, pm_dec, pm_ra, src_dec, src_ra,
		csize, op, ny, nx, separable, transpose):
	"""Every (active cell, object slot) pair on the map's device. mflat is
	[ncomp, ny, nx]. Forward: the map with the objects combined by op
	(written into mflat where it needs no padding). Transpose: [ncomp, nobj],
	the exact transpose of the op="add" paint. prof_b is [nprof, ns] on an
	equispaced radius grid of step prof_dr[nprof]."""
	ncomp, nobj = mflat.shape[0], src_dec.shape[0]
	cs = csize
	ncy, ncx = -(-ny//cs), -(-nx//cs)
	nact, K = cell_src.shape
	pad_y, pad_x = ncy*cs - ny, ncx*cs - nx
	mp = torch.nn.functional.pad(mflat, (0, pad_x, 0, pad_y)) if pad_y or pad_x else mflat.contiguous()
	view = mp.view(ncomp, ncy, cs, ncx, cs)
	ns = prof_b.shape[1]
	prof_flat = prof_b.reshape(-1)
	ar = torch.arange(cs, device=mflat.device)
	oamp = torch.zeros((ncomp, nobj), dtype=mflat.dtype, device=mflat.device) if transpose else None
	step = max(1, PAINT_CHUNK//(cs*cs))
	for c0 in range(0, nact, step):
		ids, csrc = cell_ids[c0:c0+step], cell_src[c0:c0+step]
		cy, cx = ids // ncx, ids % ncx
		cblocks = view[:, cy, :, cx, :]                  # [n, ncomp, cs, cs]
		iy, ix = cy[:, None]*cs + ar, cx[:, None]*cs + ar  # [n, cs]
		inmap = (iy < ny)[:, :, None] & (ix < nx)[:, None, :]
		iyc, ixc = iy.clamp(max=ny-1), ix.clamp(max=nx-1)
		if separable:
			pdec, pra = pm_dec[iyc][:, :, None], pm_ra[ixc][:, None, :]
		else:
			pdec, pra = pm_dec[iyc[:, :, None], ixc[:, None, :]], pm_ra[iyc[:, :, None], ixc[:, None, :]]
		if transpose:
			acc = None
		elif op == "add":
			acc = torch.zeros_like(cblocks)
		else:
			acc = torch.full_like(cblocks, -np.inf if op == "max" else np.inf)
		for k in range(K):
			sid = csrc[:, k]
			valid = sid >= 0
			sidc = sid.clamp(min=0)
			pid = prof_ids[sidc]
			r = _angdist(pra, pdec, src_ra[sidc][:, None, None], src_dec[sidc][:, None, None])
			# equispaced linear interpolation, 0 beyond the table
			t = r/prof_dr[pid][:, None, None]
			i0 = t.to(torch.int32).clamp(0, ns-2)
			f = (t - i0).clamp(0.0, 1.0)
			base = pid[:, None, None]*ns + i0
			br = prof_flat[base]*(1 - f) + prof_flat[base + 1]*f
			ok = valid[:, None, None] & inmap
			br = torch.where((t < ns - 1) & ok, br, 0.0)
			if transpose:
				s = torch.einsum("acyx,ayx->ca", cblocks, br)
				oamp.index_add_(1, sidc, torch.where(valid[None, :], s, 0.0))
				continue
			val = amps[:, sidc].T[:, :, None, None]*br[:, None]
			if op == "add":
				acc += val
			elif op == "max":
				acc = torch.maximum(acc, torch.where(ok[:, None], val, -np.inf))
			else:
				acc = torch.minimum(acc, torch.where(ok[:, None], val, np.inf))
		if transpose: continue
		if op == "add":
			out = cblocks + acc
		elif op == "max":
			out = torch.maximum(cblocks, torch.where(torch.isfinite(acc), acc, -np.inf))
		else:
			out = torch.minimum(cblocks, torch.where(torch.isfinite(acc), acc, np.inf))
		view[:, cy, :, cx, :] = out
	if transpose: return oamp
	return mp[:, :ny, :nx]


def _norm_profiles(profile):
	"""A profile spec as a list of [2, ns] arrays; a scalar is a Gaussian sigma."""
	if np.isscalar(profile) or np.ndim(profile) == 0:
		return [expand_beam(profile)]
	if isinstance(profile, (tuple, list)) and np.ndim(profile[0]) > 1 or \
			(isinstance(profile, list) and len(profile) and np.ndim(profile[0]) == 2):
		return [np.asarray(p) for p in profile]
	if np.ndim(profile) == 3:
		return [np.asarray(p) for p in profile]
	return [np.asarray(profile)]

def _equi_profiles(profs, dtype):
	"""The profiles resampled onto equispaced radius grids of one common
	sample count (equispaced ones pass through exactly): (prof_b[nprof,
	ns], prof_dr[nprof])."""
	ns = max(max(len(p[0]) for p in profs), 2)
	if not all(is_equi(p[0]) for p in profs):
		ns = max(ns, 2048)  # dense enough for non-uniform tables
	prof_b = np.zeros((len(profs), ns), dtype)
	prof_dr = np.zeros(len(profs), dtype)
	for i, p in enumerate(profs):
		r, b = np.asarray(p[0], float), np.asarray(p[1], float)
		if is_equi(r) and len(r) == ns:
			prof_b[i] = b
			prof_dr[i] = r[1]
		else:
			re = np.linspace(0, r[-1], ns)
			prof_b[i] = np.interp(re, r, b)
			prof_dr[i] = re[1] if ns > 1 else 1.0
	return prof_b, prof_dr

def _per_source_rmax(profs, prof_ids, amax, vmin, rmax):
	"""The largest radius where |amax_i b(r)| >= vmin for each object,
	capped by rmax where given."""
	out = np.zeros(len(prof_ids))
	for ip, p in enumerate(profs):
		sel = prof_ids == ip
		if not sel.any(): continue
		r, b = np.asarray(p[0], float), np.abs(np.asarray(p[1], float))
		env = np.maximum.accumulate(b[::-1])[::-1]  # non-increasing tail max
		th = vmin/np.maximum(amax[sel], 1e-30)
		idx = len(env) - np.searchsorted(env[::-1], th, side="left")
		out[sel] = r[np.clip(idx - 1, 0, len(r) - 1)]
	if rmax: out = np.minimum(out, rmax)
	return out

def _dtypes(dtype):
	"""(torch dtype, numpy dtype) of a numpy or torch float dtype."""
	tdt = enmap._torch_dtype(dtype)
	return tdt, (np.float32 if tdt == torch.float32 else np.float64)


def sim_objects(shape, wcs, poss, amps, profile, prof_ids=None, omap=None, vmin=None, rmax=None, op="add",
		pixwin=False, separable="auto", transpose=False, prof_equi=None, return_times=False,
		dtype=np.float32, csize=CSIZE, *, device="cuda"):
	"""Radial profiles painted at poss[{dec, ra}, nobj] with amplitudes
	amps[nobj] (or [..., nobj]) (pixell_tpu.pointsrcs.sim_objects :232).

	profile: an (r, br) pair, or a list of them selected by prof_ids; vmin:
	each profile truncated where |br amax_i| < vmin (default min |amps| times
	1e-3); rmax: a hard radius cap. The result is a new map (omap, where
	given, is added to and left as it was), on omap's device or device.

	transpose=True computes the exact adjoint of the op="add" paint,
	amp_out[..., i] = sum_pix map[..., pix] b_i(pix), reading omap (a zero
	map where None), and returns it shaped like amps, a tensor on the map's
	device."""
	tdt, ndt = _dtypes(dtype)
	poss = np.asarray(poss)
	amps = np.asarray(amps, ndt)
	pre = amps.shape[:-1]
	nobj = poss.shape[1] if poss.ndim > 1 else 0
	amps_flat = amps.reshape(-1, nobj) if nobj else amps.reshape(-1, 0)
	ncomp = amps_flat.shape[0]
	if omap is None:
		omap = enmap.zeros(pre + tuple(shape[-2:]), wcs, tdt, device=device)
		fresh = True
	else:
		fresh = False
	dev = omap.device
	if nobj == 0 or ncomp == 0:
		return torch.zeros(amps.shape, dtype=tdt, device=dev) if transpose else omap
	profs = _norm_profiles(profile)
	if prof_ids is None: prof_ids = np.zeros(nobj, int)
	prof_ids = np.asarray(prof_ids, int)
	# the truncation radius of each object from vmin
	amax = np.max(np.abs(amps_flat), 0)
	if vmin is None:
		vmin = np.min(np.abs(amps_flat[amps_flat != 0]))*1e-3 if np.any(amps_flat != 0) else 1e-3
	rmax_i = _per_source_rmax(profs, prof_ids, amax, vmin, rmax)
	prof_b, prof_dr = _equi_profiles(profs, ndt)
	# pixel radii; the RA compression widens the stamp by 1/cos(dec)
	res_rad = np.abs(np.asarray(wcs.wcs.cdelt))*utils.degree
	dec = np.asarray(poss[0], float)
	cosd = np.maximum(np.cos(np.minimum(np.abs(dec) + rmax_i, np.pi/2*0.999)), 1e-3)
	Ry = np.minimum(np.ceil(rmax_i/res_rad[1]).astype(int) + 1, shape[-2])
	Rx = np.minimum(np.ceil(rmax_i/(res_rad[0]*cosd)).astype(int) + 1, shape[-1])
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
	if separable:
		decax, raax = enmap.posaxes(shape, wcs)
		pm_dec, pm_ra = on(np.asarray(decax, ndt)), on(np.asarray(raax, ndt))
	else:
		pm = enmap.posmap(shape, wcs, safe=False, device=dev).data
		pm_dec, pm_ra = pm[0].to(tdt), pm[1].to(tdt)
	pix = np.round(np.asarray(enmap.sky2pix(shape, wcs, poss))).astype(np.int32)
	wrapx = abs(abs(wcs.wcs.cdelt[0])*shape[-1] - 360.0) < 1e-6
	cell_ids, cell_src = _build_cells(pix, Ry, Rx, shape[-2], shape[-1], csize, bool(wrapx))
	if len(cell_ids) == 0:
		return torch.zeros(amps.shape, dtype=tdt, device=dev) if transpose else omap
	data = omap.data.to(tdt).reshape((ncomp,) + tuple(shape[-2:]))
	if transpose and pixwin:
		# the adjoint of (apply_window o paint): the window is a real symmetric
		# Fourier multiplier, so its own adjoint
		data = enmap.apply_window(enmap.ndmap(data, wcs)).data.to(tdt)
	elif not transpose and not fresh:
		data = data.clone()
	# the tables go to the device as int32 (half the copy) and widen there
	out = _paint_cells(data, on(cell_ids).long(), on(cell_src).long(), on(amps_flat),
		on(prof_b), on(prof_dr), on(prof_ids.astype(np.int32)).long(), pm_dec, pm_ra, on(np.asarray(poss[0], ndt)),
		on(np.asarray(poss[1], ndt)), int(csize), op, shape[-2], shape[-1], bool(separable), bool(transpose))
	if transpose:
		return out.reshape(amps.shape)
	res = enmap.ndmap(out.reshape(omap.shape), wcs)
	if pixwin:
		res = enmap.apply_window(res)
	return res


def _radial_bins(marr, pix, src_dec, src_ra, bsize, R, nbin, pm_dec, pm_ra, ny, nx, wrapx, separable):
	"""[nobj, ..., nbin]: each object's (2R+1)^2 window summed in radial
	bins, objects in batches of RADIAL_CHUNK window pixels."""
	dev = marr.device
	pre = marr.shape[:-2]
	W = 2*R + 1
	d = torch.arange(-R, R+1, device=dev)
	mflat = marr.reshape((-1,) + marr.shape[-2:])
	nc = mflat.shape[0]
	nobj = pix.shape[1]
	out = torch.zeros((nobj, nc, nbin), dtype=marr.dtype, device=dev)
	step = max(1, RADIAL_CHUNK//(W*W))
	for s0 in range(0, nobj, step):
		p, sdec, sra = pix[:, s0:s0+step], src_dec[s0:s0+step], src_ra[s0:s0+step]
		S = p.shape[1]
		iy, ix = p[0][:, None] + d, p[1][:, None] + d        # [S, W]
		iyc = iy.clamp(0, ny-1)
		ixc = ix % nx if wrapx else ix.clamp(0, nx-1)
		if separable:
			pdec, pra = pm_dec[iyc][:, :, None], pm_ra[ixc][:, None, :]
		else:
			pdec, pra = pm_dec[iyc[:, :, None], ixc[:, None, :]], pm_ra[iyc[:, :, None], ixc[:, None, :]]
		r = _angdist(pra, pdec, sra[:, None, None], sdec[:, None, None])   # [S, W, W]
		good = ((iy >= 0) & (iy < ny))[:, :, None]
		if not wrapx: good = good & ((ix >= 0) & (ix < nx))[:, None, :]
		rb = r/bsize
		ib = torch.where(good, rb.to(torch.int64).clamp(max=nbin-1), nbin-1)
		vals = mflat[:, iyc[:, :, None], ixc[:, None, :]]                    # [nc, S, W, W]
		vals = torch.where(good & (rb < nbin), vals, 0.0)
		idx = (torch.arange(S, device=dev)[:, None, None]*nbin + ib).reshape(1, -1).expand(nc, -1)
		acc = torch.zeros((nc, S*nbin), dtype=marr.dtype, device=dev)
		acc.scatter_add_(1, idx, vals.reshape(nc, -1))
		out[s0:s0+S] = acc.reshape(nc, S, nbin).transpose(0, 1)
	return out.reshape((nobj,) + tuple(pre) + (nbin,))

def radial_sum(map, poss, bins, oprofs=None, separable="auto"):
	"""The map's values summed in radial bins around each object
	(pixell_tpu.pointsrcs.radial_sum :337): [nobj, ..., nbin], a tensor on
	the map's device."""
	poss = np.asarray(poss)
	bins = np.asarray(bins)
	bsize = bins[1] - bins[0]
	nbin = len(bins) - 1 if len(bins) > 1 else 1
	shape, wcs = map.shape, map.wcs
	rmax = bins[-1]
	res_rad = np.abs(np.asarray(wcs.wcs.cdelt))*utils.degree
	dec_max = np.max(np.abs(poss[0])) if poss.size else 0
	cosd = max(np.cos(min(abs(dec_max) + rmax, np.pi/2*0.999)), 1e-3)
	R = min(int(np.ceil(rmax/min(res_rad)/cosd)) + 1, max(shape[-2:]))
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	dev = map.device
	if separable:
		dec, ra = enmap.posaxes(shape, wcs)
		pm_dec, pm_ra = torch.from_numpy(np.asarray(dec)).to(dev), torch.from_numpy(np.asarray(ra)).to(dev)
	else:
		pm = enmap.posmap(shape, wcs, safe=False, device=dev).data
		pm_dec, pm_ra = pm[0], pm[1]
	pix = np.round(np.asarray(enmap.sky2pix(shape, wcs, poss))).astype(np.int64)
	wrapx = abs(abs(wcs.wcs.cdelt[0])*shape[-1] - 360.0) < 1e-6
	on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
	return _radial_bins(map.data, on(pix), on(np.asarray(poss[0], float)), on(np.asarray(poss[1], float)),
		float(bsize), int(R), int(nbin), pm_dec.to(torch.float64), pm_ra.to(torch.float64), shape[-2], shape[-1],
		bool(wrapx), bool(separable))

def radial_bin(map, poss, bins, separable="auto"):
	"""The map's values averaged in radial bins around each object:
	[nobj, ..., nbin]. (The reference divides the sums [nobj, ..., nbin] by
	the hits [nobj, nbin] as they stand, which raises for a map with
	components; the port puts the hits beside the components.)"""
	sums = radial_sum(map, poss, bins, separable=separable)
	ones = enmap.ndmap(torch.ones(map.shape[-2:], dtype=map.dtype, device=map.device), map.wcs)
	hits = radial_sum(ones, poss, bins, separable=separable)
	hits = hits.reshape((hits.shape[0],) + (1,)*(sums.ndim - 2) + (hits.shape[-1],))
	return sums/torch.clamp(hits, min=1)


def sim_srcs(shape, wcs, srcs, beam, omap=None, dtype=np.float32, nsigma=5, rmax=None, smul=1,
		return_padded=False, pixwin=False, op="add", separable="auto", method="c", *, device="cuda"):
	"""The legacy point-source simulation: srcs[nsrc, {dec, ra, amp}] with a
	beam (pixell_tpu.pointsrcs.sim_srcs :373)."""
	srcs = np.asarray(srcs)
	prof = expand_beam(beam, rmax=rmax)
	poss = srcs[:, :2].T
	amps = srcs[:, 2].astype(_dtypes(dtype)[1])
	return sim_objects(shape, wcs, poss, amps, prof, omap=omap, rmax=rmax, op=op, pixwin=pixwin,
		separable=separable, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Catalogue IO (pixell_tpu/pointsrcs.py:391-478, 603-752): text, HDF5 and
# FITS binary tables
# ---------------------------------------------------------------------------
def read(fname, format="auto", amp_factor=None):
	"""A point-source catalogue: "simple" (text ra dec amp), "hdf", or a
	FITS binary table, "fits" (ra / dec columns), "nemo" (RADeg / decDeg /
	deltaT_c), "dory" or "sauron", as read_fits_cat reads them."""
	if format == "auto":
		if fname.endswith(".txt") or fname.endswith(".cat"): format = "simple"
		elif fname.endswith(".hdf") or fname.endswith(".h5"): format = "hdf"
		elif fname.endswith(".fits") or fname.endswith(".fits.gz"): format = "fits"
		else: format = "simple"
	if format == "simple": return read_simple(fname)
	if format == "hdf": return read_hdf_cat(fname)
	if format in ["fits", "nemo", "dory", "sauron"]:
		return read_fits_cat(fname, format=format)
	raise ValueError("Unknown catalog format '%s'" % format)

def read_fits_cat(fname, format="fits"):
	"""A FITS binary-table catalogue as a Bunch of ra, dec (radians), I and,
	where the table has them, Q, U and snr: nemo's columns (RADeg, decDeg,
	deltaT_c / y_c / fixed_y_c), or ra / dec (radians if they fit, else
	degrees) with amp / flux / flux_T / I / T."""
	tab = fits_io.read_table(fname)
	cols = {k.lower(): k for k in tab if not k.startswith("_")}
	res = Bunch()
	def get(*names):
		for n in names:
			if n.lower() in cols: return np.asarray(tab[cols[n.lower()]])
		return None
	if format == "nemo" or (format == "fits" and "radeg" in cols):
		res.ra = get("RADeg")*utils.degree
		res.dec = get("decDeg")*utils.degree
		amp = get("deltaT_c", "y_c", "fixed_y_c")
		res.I = amp if amp is not None else np.ones(len(res.ra))
	else:
		ra = get("ra", "ra_deg")
		dec = get("dec", "dec_deg")
		unit = 1.0 if (ra is not None and np.max(np.abs(ra)) <= 2*np.pi+0.1) else utils.degree
		res.ra = ra*unit
		res.dec = dec*unit
		amp = get("amp", "flux", "flux_T", "I", "T")
		res.I = amp if amp is not None else np.ones(len(res.ra))
		for key, names in [("Q", ["Q", "flux_Q"]), ("U", ["U", "flux_U"]), ("snr", ["snr", "SNR"])]:
			v = get(*names)
			if v is not None: res[key] = v
	if res.I is not None and res.I.ndim == 2:
		res.I = res.I[:, 0]
	return res

def write_fits_cat(fname, cat):
	"""A catalogue Bunch as a FITS binary table: ra, dec in degrees, amp, and
	Q, U, snr where it has them."""
	cols = dict(ra=np.asarray(cat.ra)/utils.degree, dec=np.asarray(cat.dec)/utils.degree, amp=np.asarray(cat.I))
	for key in ["Q", "U", "snr"]:
		if key in cat: cols[key] = np.asarray(cat[key])
	fits_io.write_table_fits(fname, cols)

def read_simple(fname):
	"""A text catalogue: ra dec amp [amp2 amp3] in degrees and uK."""
	data = np.loadtxt(fname, ndmin=2)
	res = Bunch()
	res.ra = data[:, 0]*utils.degree
	res.dec = data[:, 1]*utils.degree
	res.I = data[:, 2] if data.shape[1] > 2 else np.ones(len(data))
	if data.shape[1] > 3: res.Q = data[:, 3]
	if data.shape[1] > 4: res.U = data[:, 4]
	return res

def read_hdf_cat(fname):
	return _bunch.read(fname)

def write_simple(fname, cat):
	cols = [cat.ra/utils.degree, cat.dec/utils.degree, cat.I]
	for key in ["Q", "U"]:
		if key in cat: cols.append(cat[key])
	np.savetxt(fname, np.array(cols).T, fmt="%12.6f")

def src2param(srcs):
	"""A catalogue Bunch as the [nsrc, {dec, ra, amps...}] array."""
	if hasattr(srcs, "ra"):
		cols = [srcs.dec, srcs.ra, srcs.I]
		for key in ["Q", "U"]:
			if key in srcs: cols.append(srcs[key])
		return np.array(cols).T
	return np.asarray(srcs)


# ---------------------------------------------------------------------------
# Source cells and the remaining catalogue formats
# ---------------------------------------------------------------------------
def is_equi(r):
	"""Whether r is an equispaced grid starting at 0."""
	r = np.asarray(r)
	return len(r) > 1 and r[0] == 0 and np.allclose(r[-1], (len(r)-1)*r[1])

def sim_srcs_python(shape, wcs, srcs, beam, omap=None, dtype=None, nsigma=5, rmax=None, smul=1,
		return_padded=False, pixwin=False, pixwin_order=0, op=None, wrap="auto", verbose=False, cache=None,
		separable="auto", *, device="cuda"):
	"""The sky-coordinate painter: the cell painter of sim_srcs. (The
	reference passes verbose on to sim_srcs, which takes none, and raises
	TypeError; the port does not pass it.)"""
	return sim_srcs(shape, wcs, srcs, beam, omap=omap, dtype=dtype or np.float32, nsigma=nsigma, smul=smul,
		pixwin=pixwin, device=device)

def sim_srcs_dist_transform(shape, wcs, srcs, beam, omap=None, dtype=None, nsigma=4, rmax=None, smul=1,
		pixwin=False, ignore_outside=False, op=None, verbose=False, *, device="cuda"):
	"""Point sources painted through a distance transform from their
	positions (pixell_tpu.pointsrcs.sim_srcs_dist_transform :499): each
	pixel takes the beam of its nearest source only, out to rmax (nsigma
	times the beam's sigma by default), so crowded fields cost no more than
	sparse ones. The distances and domains are distances.distance_from_points
	(K14 up to 1024 sources, K13 above), on omap's device or device."""
	from . import distances
	srcs = np.asarray(srcs)
	r, b = expand_beam(beam)
	if rmax is None:
		sigma_eff = r[np.argmin(np.abs(b - b[0]*np.exp(-0.5)))]
		rmax = nsigma*max(sigma_eff, r[1])
	dev = omap.device if omap is not None else torch.device(device)
	dists, domains = distances.distance_from_points(tuple(shape[-2:]), wcs, srcs[:, :2].T, domains=True,
		rmax=rmax, device=dev)
	amp = torch.from_numpy(np.ascontiguousarray(srcs[:, 2]*smul, np.float64)).to(dev)
	vals = utils.interp(dists.data, torch.from_numpy(np.asarray(r, np.float64)).to(dev),
		torch.from_numpy(np.asarray(b, np.float64)).to(dev), right=0.0)
	dom = domains.data
	out = torch.where(dom >= 0, vals*amp[dom.clamp(0, len(amp)-1).to(torch.int64)], 0.0)
	res = enmap.ndmap(out.to(_dtypes(dtype or np.float32)[0]), wcs)
	if omap is not None: res = enmap.samewcs(omap.data + res.data, res)
	return res


def eval_srcs_loop(posmap, poss, amps, beam, cres, nhit, cell_srcs, dtype=np.float64, op=None,
		verbose=False):
	"""Direct evaluation of every source at every pixel of posmap [{dec,
	ra}, ny, nx] (host numpy)."""
	posmap = np.asarray(posmap)
	r, b = beam
	model = np.zeros(posmap.shape[-2:], dtype)
	for si in range(len(np.atleast_2d(poss))):
		p = np.atleast_2d(poss)[si]
		d = utils.angdist(np.stack([posmap[1], posmap[0]]), np.array([p[1], p[0]])[:, None, None], axis=0)
		model += np.atleast_1d(amps)[si]*np.interp(d, r, b, right=0)
	return model

def build_src_cells(cbox, srcpos, cres, unwind=False, wrap=None):
	"""Sources assigned to coarse cells of cbox: (ncell[cy, cx], cells[cy,
	cx, nmax]) of source indices (host numpy)."""
	cbox = np.asarray(cbox)
	srcpos = np.asarray(srcpos)[:, :2]
	cshape = tuple(np.ceil((cbox[1] - cbox[0])/cres).astype(int))
	if unwind:
		ref = np.mean(cbox[:, 1], 0)
		srcpos = srcpos.copy()
		srcpos[:, 1] = utils.rewind(srcpos[:, 1], ref)
	lists = [[[] for _ in range(cshape[1])] for _ in range(cshape[0])]
	inv_dc = np.array(cshape)/(cbox[1] - cbox[0])
	woffs_y = [0] if not wrap or wrap[0] == 0 else [-wrap[0], 0, wrap[0]]
	woffs_x = [0] if not wrap or wrap[1] == 0 else [-wrap[1], 0, wrap[1]]
	cres2 = np.zeros(2) + cres
	for si, pos in enumerate(srcpos):
		for wy in woffs_y:
			for wx in woffs_x:
				wpos = pos + np.array([wy, wx])
				i1 = np.maximum(((wpos - cres2 - cbox[0])*inv_dc).astype(int), 0)
				i2 = np.minimum(((wpos + cres2 - cbox[0])*inv_dc).astype(int) + 1, cshape)
				for cy in range(i1[0], i2[0]):
					for cx in range(i1[1], i2[1]):
						lists[cy][cx].append(si)
	nmax = max(1, max(len(c) for row in lists for c in row))
	ncell = np.zeros(cshape, np.int32)
	cells = np.zeros(cshape + (nmax,), np.int32)
	for cy in range(cshape[0]):
		for cx in range(cshape[1]):
			n = len(lists[cy][cx])
			ncell[cy, cx] = n
			cells[cy, cx, :n] = lists[cy][cx]
	return ncell, cells

def build_src_cells_helper(cbox, cshape, cres, srcpos, nmax=0, wrap=None):
	srcpos = np.asarray(srcpos)
	ncell, cells = build_src_cells(cbox, srcpos.reshape(-1, srcpos.shape[-1]), cres, wrap=wrap)
	if nmax == 0: return ncell
	return ncell, cells

def cellify(map, res):
	"""The map as a grid of cells [..., ncy, ncx, ry, rx], the partial cells
	at the end dropped: a view of a tensor (an ndmap's data), else numpy."""
	res = np.array(res, int)
	arr = map.data if isinstance(map, enmap.ndmap) else map
	if not isinstance(arr, torch.Tensor): arr = np.asarray(arr)
	cshape = np.array(arr.shape[-2:])//res
	omap = arr[..., :cshape[0]*res[0], :cshape[1]*res[1]]
	omap = omap.reshape(tuple(omap.shape[:-2]) + (int(cshape[0]), int(res[0]), int(cshape[1]), int(res[1])))
	return utils.moveaxis(omap, -3, -2)

def uncellify(cmap):
	cmap = cmap if isinstance(cmap, torch.Tensor) else np.asarray(cmap)
	omap = utils.moveaxis(cmap, -2, -3)
	return omap.reshape(tuple(omap.shape[:-4]) + (omap.shape[-4]*omap.shape[-3], omap.shape[-2]*omap.shape[-1]))

def crossmatch(srcs1, srcs2, tol=1*utils.degree/60, safety=4):
	"""Each source of srcs1 [:, {ra, dec}, ...] paired with its closest in
	srcs2 within tol (radians): the list of index pairs. (The reference
	passes tol= to utils.crossmatch, which takes rmax, and raises TypeError.)"""
	s1, s2 = np.asarray(srcs1), np.asarray(srcs2)
	return utils.crossmatch(s1[:, 1::-1], s2[:, 1::-1], tol, mode="closest")

def translate_dtype_keys(d, translation):
	"""A record array with its fields renamed."""
	descr = [(name if name not in translation else translation[name], char) for name, char in d.dtype.descr]
	return np.asarray(d, descr)

def read_nemo(fname):
	"""The nemo text catalogue format."""
	idtype = [("name", "2S64"), ("ra", "d"), ("dec", "d"), ("snr", "d"), ("npix", "i"), ("detfrac", "d"),
		("template", "S32"), ("glat", "d"), ("I", "d"), ("dI", "d")]
	try:
		icat = np.loadtxt(fname, dtype=idtype)
	except (ValueError, IndexError):
		idtype = [("name", "2S64"), ("ra", "d"), ("dec", "d"), ("snr", "d"), ("npix", "i"),
			("template", "S32"), ("glat", "d"), ("I", "d"), ("dI", "d")]
		try:
			icat = np.loadtxt(fname, dtype=idtype)
		except (ValueError, IndexError) as e:
			raise IOError(str(e))
	icat = np.atleast_1d(icat)
	odtype = [("name", "S64"), ("ra", "d"), ("dec", "d"), ("snr", "d"), ("I", "d"), ("dI", "d"), ("npix", "i"),
		("template", "S32"), ("glat", "d")]
	ocat = np.zeros(len(icat), odtype).view(np.recarray)
	ocat.name = np.char.add(np.char.add(icat["name"][:, 0], b" "), icat["name"][:, 1])
	for f in ["ra", "dec", "snr", "I", "dI", "npix", "template", "glat"]:
		if f in icat.dtype.names: ocat[f] = icat[f]
	ocat.ra *= utils.degree
	ocat.dec *= utils.degree
	return ocat

def read_dory_fits(fname, hdu=1):
	"""The dory FITS catalogue: ra, dec (radians) and I, Q, U (amp in mK, to uK)."""
	tab = fits_io.read_table(fname, hdu=hdu)
	d = {k.lower(): v for k, v in tab.items()}
	ocat = np.zeros(len(d["ra"]), dtype=[("ra", "d"), ("dec", "d"), ("I", "d"), ("Q", "d"),
		("U", "d")]).view(np.recarray)
	ocat.ra = d["ra"]*utils.degree
	ocat.dec = d["dec"]*utils.degree
	amp = np.asarray(d["amp"])
	ocat.I, ocat.Q, ocat.U = np.atleast_2d(amp.T)*1e3
	return ocat

def read_dory_txt(fname):
	try:
		d = np.loadtxt(fname, usecols=[0, 1, 3, 5, 7],
			dtype=[("ra", "d"), ("dec", "d"), ("I", "d"), ("Q", "d"), ("U", "d")])
		d = np.atleast_1d(d).view(np.recarray)
		for f, s in [("I", 1e3), ("Q", 1e3), ("U", 1e3), ("ra", utils.degree), ("dec", utils.degree)]:
			d[f] = d[f]*s
		return d
	except (ValueError, IndexError) as e:
		raise IOError(str(e))

def read_fits(fname, hdu=1, fix=True):
	"""A FITS binary-table catalogue as a record array; with fix, nemo's
	RADeg, decDeg, deltaT_c, err_deltaT_c renamed ra, dec, I, dI.
	(pixell_tpu.pointsrcs.read_fits passes the table's "_header" entry on as
	a column and raises ValueError: ROADMAP Queue 3.)"""
	tab = {k: v for k, v in fits_io.read_table(fname, hdu=hdu).items() if not k.startswith("_")}
	rec = np.rec.fromarrays(list(tab.values()), names=",".join(tab.keys()))
	if fix:
		rec = translate_dtype_keys(rec, {"RADeg": "ra", "decDeg": "dec", "deltaT_c": "I",
			"err_deltaT_c": "dI"}).view(np.recarray)
	return rec

def format_sauron(cat):
	"""A sauron catalogue as text."""
	cat = cat.view(np.recarray)
	nfield, ncomp = cat.flux.shape[-2:]
	names = "TQU"
	header = "#%8s %8s %9s" % ("ra", "dec", "snr_T")
	for i in range(1, ncomp): header += " %8s" % ("snr_" + names[i])
	for i in range(ncomp): header += " %8s %7s" % ("ftot_" + names[i], "dftot_" + names[i])
	for i in range(nfield):
		for j in range(ncomp):
			header += " %8s %7s" % ("flux_%s%d" % (names[j], i+1), "dflux_%s%d" % (names[j], i+1))
	header += " %2s" % "ca"
	for i in range(nfield): header += " %7s" % ("cont_%d" % (i+1))
	header += "\n"
	res = header
	for i in range(len(cat)):
		line = "%9.4f %8.4f" % (cat.ra[i]/utils.degree, cat.dec[i]/utils.degree)
		snr = np.atleast_1d(cat.snr[i]).reshape(-1)
		line += " %9.2f" % snr[0]
		for s in snr[1:]: line += " %7.2f" % s
		ftot = np.atleast_1d(cat.flux_tot[i]).reshape(-1)
		dftot = np.atleast_1d(cat.dflux_tot[i]).reshape(-1)
		for f, df in zip(ftot, dftot): line += " %8.2f %7.2f" % (f, df)
		fl = np.atleast_2d(cat.flux[i]); dfl = np.atleast_2d(cat.dflux[i])
		for fi in range(nfield):
			for ci in range(ncomp):
				line += " %8.2f %7.2f" % (fl[fi, ci], dfl[fi, ci])
		line += " %2d" % cat.case[i]
		cont = np.atleast_1d(cat.contam[i]) if "contam" in cat.dtype.names else np.zeros(nfield)
		for c in cont.reshape(-1)[:nfield]: line += " %7.4f" % c
		res += line + "\n"
	return res

def write_sauron_txt(ofile, cat):
	with open(ofile, "w") as f:
		f.write(format_sauron(cat))

def read_sauron_txt(ifile, ncomp=3):
	raw = np.loadtxt(ifile, ndmin=2)
	nrow, ncol = raw.shape
	nfreq = (ncol - 2 - ncomp - 1 - 2*ncomp)//(2*ncomp + 1)
	cat_dtype = [("ra", "d"), ("dec", "d"), ("snr", "d", (ncomp,)), ("flux_tot", "d", (ncomp,)),
		("dflux_tot", "d", (ncomp,)), ("flux", "d", (nfreq, ncomp)), ("dflux", "d", (nfreq, ncomp)),
		("case", "i"), ("contam", "d", (nfreq,))]
	ocat = np.zeros(nrow, cat_dtype).view(np.recarray)
	ocat.ra, ocat.dec, raw = raw[:, 0]*utils.degree, raw[:, 1]*utils.degree, raw[:, 2:]
	ocat.snr, raw = raw[:, :ncomp], raw[:, ncomp:]
	ocat.flux_tot, ocat.dflux_tot, raw = raw[:, 0:2*ncomp:2], raw[:, 1:2*ncomp:2], raw[:, 2*ncomp:]
	nf = 2*ncomp*nfreq
	ocat.flux = raw[:, 0:nf:2].reshape(-1, nfreq, ncomp)
	ocat.dflux = raw[:, 1:nf:2].reshape(-1, nfreq, ncomp)
	raw = raw[:, nf:]
	ocat.case = raw[:, 0].astype(int)
	ocat.contam = raw[:, 1:1+nfreq]
	return ocat

def write_sauron_fits(ofile, cat):
	"""A sauron catalogue (record array) as a FITS binary table, ra / dec in degrees."""
	ocat = np.array(cat).view(np.recarray)
	ocat.ra = ocat.ra/utils.degree
	ocat.dec = ocat.dec/utils.degree
	cols = [np.ascontiguousarray(ocat[n]) for n in ocat.dtype.names]
	fits_io.write_table_fits(ofile, dict(zip(ocat.dtype.names, cols)))

def read_sauron_fits(fname):
	tab = fits_io.read_table(fname, hdu=1)
	names = [k for k in tab if not k.startswith("_")]
	dtypes = [(n, tab[n].dtype.str, tab[n].shape[1:]) if np.ndim(tab[n]) > 1 else (n, tab[n].dtype.str)
		for n in names]
	cat = np.zeros(len(tab[names[0]]), dtype=dtypes).view(np.recarray)
	for n in names: cat[n] = tab[n]
	cat.ra = cat.ra*utils.degree
	cat.dec = cat.dec*utils.degree
	return cat

def write_sauron(ofile, cat):
	if ofile.endswith(".fits"): write_sauron_fits(ofile, cat)
	else: write_sauron_txt(ofile, cat)

def read_sauron(ifile):
	if ifile.endswith(".fits"): return read_sauron_fits(ifile)
	return read_sauron_txt(ifile)
