"""The unit-vector comparison of K13 / K14 (csrc/distances.cu) on the CPU.

- The margin: over a million pairs (random, near-antipodal, under 1e-7
  rad, mirrored ties at pixel centres) the float64 dot product of the
  kernels' unit vectors and distances_core.vincenty stay, their errors
  against np.longdouble counted together, within MARGIN / 10
  (ops/distances_cuda.py derives MARGIN from these roundings).
- The wrappers' card path: distances_cuda._on_card and _call are replaced
  so that CPU tensors go through the launch arguments the kernels get
  (pointers, strides, sizes, MARGIN), read here by a numpy emulation of
  the kernels' arithmetic (dot products, the margin, Vincenty within it,
  and K14's filter: its chain of FMAs, each rounded once as __fma_rn does,
  and its skip of a step by the sign bits of a thread's pixels). Its fused
  multiply-adds are emulated exactly (fma, held to exact rational
  arithmetic here), and the filter's bound (a point dropped only where its
  dot product is below thr + 9u) is tested on pairs at their threshold.
  Its angle is computed one pair at a time with Python's math module, so
  that it does not depend on how an array is cut into vector lanes
  (torch's vectorized CPU sin and its scalar tail can differ in the last
  bit; on the card each element is computed alike, and chip_smoke.py holds
  the kernels to the plain versions bit for bit). The emulation with
  MARGIN is held bit for bit to the same emulation deciding every
  comparison by the angles (an infinite margin): the margin's claim. Both
  are held to the plain versions and to the reference's _jump_flood /
  brute force (1e-12 rad, differing seeds only at ties) at its trap steps,
  for every table layout: separable (a dec column, an RA row), HEALPix's
  [ny, W] RA table, a full posmap (TAN), with pixel seeds and a seed
  table, int32 and int64; and on a near-tie set (points mirrored about
  pixel centres, pairs 1e-15 rad apart), where the emulation must take the
  Vincenty branch.

The reference's flood runs with jax.disable_jit() (see
test_torch_distances.py).
"""
import ctypes
import math
import pathlib
import re
from fractions import Fraction

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import distances as jdist, enmap as jenmap, utils as jutils
from pixell_tpu_torch import distances, enmap, utils
from pixell_tpu_torch.ops import distances_core, distances_cuda

TOL = 1e-12
M = distances_cuda.MARGIN
U = 2.0**-53
NPAIR = 250_000   # pairs of each kind (four kinds)
# K14's layout (csrc/distances.cu): threads a block, pixels a thread, points a step of its filter
NEAR = {k: int(v) for k, v in re.findall(r"constexpr int (NEAR_BLOCK|NEAR_R|NEAR_STEP) = (\d+);",
	(pathlib.Path(distances_cuda.__file__).parent.parent/"csrc"/"distances.cu").read_text())}


# ---------------------------------------------------------------------------
# the margin
# ---------------------------------------------------------------------------
def pairs(kind, rng, n=NPAIR):
	"""(dec1, ra1, dec2, ra2) float64 [n] of one kind."""
	dec1, ra1 = np.arcsin(rng.uniform(-1, 1, n)), rng.uniform(-np.pi, np.pi, n)
	if kind == "random":
		return dec1, ra1, np.arcsin(rng.uniform(-1, 1, n)), rng.uniform(-np.pi, np.pi, n)
	if kind == "antipodal":
		eps = 10**rng.uniform(-12, -3, (2, n))*rng.choice([-1, 1], (2, n))
		dec2 = np.clip(-dec1 + eps[0], -np.pi/2, np.pi/2)
		ra2 = ra1 + np.pi + eps[1]
		return dec1, ra1, dec2, np.where(ra2 > np.pi, ra2 - 2*np.pi, ra2)
	if kind == "tiny":
		r, phi = 10**rng.uniform(-16, -7, n), rng.uniform(0, 2*np.pi, n)
		dec1 = np.clip(dec1, -1.5, 1.5)
		return dec1, ra1, dec1 + r*np.sin(phi), ra1 + r*np.cos(phi)/np.cos(dec1)
	# mirrored ties: a pixel centre of a 0.5' CAR grid and points k pixels
	# to either side of it in RA or in dec
	res = 0.5*utils.arcmin
	iy, ix = rng.integers(-10000, 10000, n), rng.integers(-21600, 21600, n)
	dec, ra = iy*res, ix*res
	k = rng.integers(1, 2000, n)*res*rng.choice([-1, 1], n)
	along = rng.uniform(size=n) < 0.5
	return dec, ra, np.where(along, dec, dec + k), np.where(along, ra + k, ra)


def unit(dec, ra):
	"""The kernels' unit vectors: sin / cos, products rounded once."""
	c = np.cos(dec)
	return np.array([c*np.cos(ra), c*np.sin(ra), np.sin(dec)])


def exact_angle(dec1, ra1, dec2, ra2):
	ld = np.longdouble
	a = [np.asarray(v, ld) for v in (dec1, ra1, dec2, ra2)]
	p = np.array([np.cos(a[0])*np.cos(a[1]), np.cos(a[0])*np.sin(a[1]), np.sin(a[0])])
	q = np.array([np.cos(a[2])*np.cos(a[3]), np.cos(a[2])*np.sin(a[3]), np.sin(a[2])])
	cr = np.cross(p, q, axis=0)
	return np.arctan2(np.sqrt(np.sum(cr*cr, 0)), np.sum(p*q, 0))


@pytest.mark.parametrize("kind", ["random", "antipodal", "tiny", "mirrored"])
def test_margin_errors(kind):
	assert np.finfo(np.longdouble).eps < 1e-18   # the reference is exact enough to count ulps of float64
	dec1, ra1, dec2, ra2 = pairs(kind, np.random.default_rng(["random", "antipodal", "tiny", "mirrored"].index(kind)))
	theta = exact_angle(dec1, ra1, dec2, ra2)
	p, q = unit(dec1, ra1), unit(dec2, ra2)
	dot = p[0]*q[0] + p[1]*q[1] + p[2]*q[2]
	vin = distances_core.vincenty(*(torch.from_numpy(v) for v in (ra1, dec1, ra2, dec2))).numpy()
	err = np.abs(dot - np.cos(theta)) + np.abs(vin - theta)
	assert float(np.max(err)) <= M/10, (kind, float(np.max(err)), M/10)


def test_margin_derivation():
	"""MARGIN is a power of two at least ten times the derived bounds
	(e_dot 17u + e_ang 38u, u = 2^-53), leaves room for K14's filter (a
	point dropped below thr + 9u, thr rounded within u) and is far below
	any dot-product gap between neighbouring pixels of a 0.5' map at the
	distance of a degree."""
	u = U
	assert M >= 10*(17 + 38)*u
	assert M - 10*u - 2*17*u - 2*38*u > 0
	assert np.log2(M) == int(np.log2(M))
	res = 0.5*utils.arcmin
	assert np.cos(utils.degree) - np.cos(utils.degree + res) > 1e4*M


# ---------------------------------------------------------------------------
# fused multiply-adds, and K14's filter
# ---------------------------------------------------------------------------
def two_sum(a, b):
	s = a + b
	t = s - a
	return s, (a - (s - t)) + (b - t)


def two_prod(a, b):
	"""(p, e): p = a b rounded, p + e = a b exactly (Dekker's product)."""
	def split(v):
		c = 134217729.0*v
		h = c - (c - v)
		return h, v - h
	p = a*b
	(ah, al), (bh, bl) = split(a), split(b)
	return p, ((ah*bh - p) + ah*bl + al*bh) + al*bl


def fma(a, b, c):
	"""a b + c rounded once to float64, as __fma_rn: the exact product and
	sum, their low parts added with rounding to odd and the result rounded
	to nearest (Boldo and Melquiond's emulation), IEEE's signed zeros, and
	numpy's arithmetic where an input is not finite."""
	a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64) for v in (a, b, c)))
	with np.errstate(invalid="ignore", over="ignore"):
		ph, pl = two_prod(a, b)
		th, tl = two_sum(c, ph)
		v, e = two_sum(tl, pl)
		odd = (v.view(np.int64) & 1) == 1
		v = np.where((e != 0) & ~odd, np.nextafter(v, np.copysign(np.inf, e)), v)
		r = th + v
		direct = a*b + c
	r = np.where(np.isfinite(a) & np.isfinite(b) & np.isfinite(c), r, direct)
	return np.where(r == 0, np.where(a*b == 0, direct, 0.0), r)


def exact_fma(a, b, c):
	return float(Fraction(a)*Fraction(b) + Fraction(c)) if a*b != 0 or c != 0 else a*b + c


def test_fma_emulation():
	"""fma against exact rational arithmetic: random triples, products that
	cancel the addend to the last bits, and sums half way between two
	doubles (a tie rounds to even)."""
	rng = np.random.default_rng(7)
	n = 20000
	a, b = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)*10.0**rng.integers(-17, 1, n)
	c = rng.uniform(-4, 4, n)*10.0**rng.integers(-17, 1, n)
	p = a*b
	k = rng.integers(-4, 5, n).astype(float)
	near = np.nextafter(-p, np.inf)*(1 + k*U)      # the addend within a few ulps of -a b
	ties = np.ldexp(1.0, 52) + 2*rng.integers(0, 2**20, n)   # even, so that + 1/2 is half way
	cases = [(a, b, c), (a, b, near), (a, b, -p), (ties, np.full(n, 1.0), np.full(n, 0.5)),
		(ties + 1, np.full(n, 1.0), np.full(n, 0.5)), (a, np.zeros(n), -np.zeros(n))]
	for x, y, z in cases:
		got = fma(x, y, z)
		want = np.array([exact_fma(*t) for t in zip(x.tolist(), y.tolist(), z.tolist())])
		assert np.array_equal(got, want) and np.array_equal(np.signbit(got), np.signbit(want))


def near_filter(q, c, thr, sep):
	"""K14's filter value for the pixels' q = (cos dec, sin dec, cos ra,
	sin ra) and points' c = (x, y, z), thr its threshold: on a separable
	geometry cos dec (cos ra x + sin ra y) + (sin dec z - thr), else
	qz z + (qy y + (qx x - thr)) with q's unit vector rounded as the
	tables' product, each FMA rounded once (csrc/distances.cu)."""
	cd, sd, ca, sa = q
	if sep:
		a = fma(sa, c[1], ca*c[0])
		return fma(cd, a, fma(sd, c[2], -thr))
	return fma(sd, c[2], fma(cd*sa, c[1], fma(cd*ca, c[0], -thr)))


@pytest.mark.parametrize("sep", [True, False])
def test_filter_bound(sep):
	"""Where the filter's sign bit is set, the dot product the kernel then
	skips, dc (the kernels' dot: a multiply and two FMAs), is below thr +
	9u: on pairs whose threshold lies within 64u of dc either side, and on
	random ones. Near the threshold the filter's rounding shows (it drops
	pairs at or above it and passes some below), so the pairs test the
	bound and not only the exact comparison."""
	rng = np.random.default_rng(8 + sep)
	n = 400_000
	dec, ra = np.arcsin(rng.uniform(-1, 1, (2, n))), rng.uniform(-np.pi, np.pi, (2, n))
	cd, sd, ca, sa = np.cos(dec[0]), np.sin(dec[0]), np.cos(ra[0]), np.sin(ra[0])
	c = unit(dec[1], ra[1])
	qx, qy = cd*ca, cd*sa
	dc = fma(sd, c[2], fma(qy, c[1], qx*c[0]))
	thr = np.concatenate([dc[:n//2] + rng.integers(-64, 65, n//2)*U, rng.uniform(-1.5, 1.5, n - n//2)])
	f = near_filter((cd, sd, ca, sa), c, thr, sep)
	drop = np.signbit(f)
	assert np.all(dc[drop] < thr[drop] + 9*U)
	gap = (dc - thr)[:n//2]
	assert gap[drop[:n//2]].max() >= 0 and gap[~drop[:n//2]].min() < 0


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated on their launch arguments
# ---------------------------------------------------------------------------
EMU = {"margin": None}                         # a margin for the emulation in place of the kernels' own
TIES = {"jump_flood": 0, "nearest_point": 0}   # Vincenty branches taken by the emulation


def view(ptr, n, ctype):
	"""n elements of ctype at address ptr, as a numpy array (no copy)."""
	return np.ctypeslib.as_array((ctype*int(n)).from_address(int(ptr))) if n > 0 else np.zeros(0)


class PixTab:
	"""The pixels' tables as the kernels read them: (sin dec, cos dec) pairs,
	ra, (cos ra, sin ra) pairs, through their strides."""
	def __init__(self, ny, nx, dsc, dsy, dsx, ra, rcs, rsy, rsx):
		nd, nr = (ny - 1)*dsy + (nx - 1)*dsx + 1, (ny - 1)*rsy + (nx - 1)*rsx + 1
		self.dsc = view(dsc, 2*nd, ctypes.c_double).reshape(-1, 2)
		self.ra, self.rcs = view(ra, nr, ctypes.c_double), view(rcs, 2*nr, ctypes.c_double).reshape(-1, 2)
		self.nx, self.strides = nx, (dsy, dsx, rsy, rsx)

	def site(self, p):
		"""(unit vector [3, n], ra, sin dec, cos dec) of flat pixels p."""
		y, x = p//self.nx, p % self.nx
		dsy, dsx, rsy, rsx = self.strides
		i, j = y*dsy + x*dsx, y*rsy + x*rsx
		s, c = self.dsc[i, 0], self.dsc[i, 1]
		return np.array([c*self.rcs[j, 0], c*self.rcs[j, 1], s]), self.ra[j], s, c


def table_site(vec, sph, k):
	return vec[k, :3].T, sph[k, 0], sph[k, 1], sph[k, 2]


def pick(site, m):
	"""The sites of site (as PixTab.site gives them) at mask or index m."""
	return tuple(a[..., m] for a in site)


def vincenty1(ra1, s1, c1, ra2, s2, c2):
	"""csrc/distances.cu's vincenty for one pair, each operation rounded."""
	dra = ra2 - ra1
	sd, cd = math.sin(dra), math.cos(dra)
	return math.atan2(math.hypot(c2*sd, c1*s2 - s1*c2*cd), s1*s2 + c1*c2*cd)


def angle(a, b):
	return np.array([vincenty1(*v) for v in zip(*(np.broadcast_to(x, np.shape(a[1])).tolist()
		for x in (a[1], a[2], a[3], b[1], b[2], b[3])))], float)


def dots(a, b):
	"""The kernels' dot product of the sites' unit vectors: a multiply and
	two FMAs."""
	return fma(a[0][2], b[0][2], fma(a[0][1], b[0][1], a[0][0]*b[0][0]))


def emulate_flood(idx64, seed_in, seed_out, d_out, dsc, dsy, dsx, ra, rcs, rsy, rsx, vec, sph, ny, nx, sy, sx,
		wrapx, margin):
	assert margin == M and seed_in != seed_out
	margin = EMU["margin"] or margin
	n = ny*nx
	it = ctypes.c_int64 if idx64 else ctypes.c_int32
	own = view(seed_in, n, it).astype(np.int64)
	pix = PixTab(ny, nx, dsc, dsy, dsx, ra, rcs, rsy, rsx)
	if vec:
		ns = int(own.max()) + 1 if n else 0
		vt, st = view(vec, 4*ns, ctypes.c_double).reshape(-1, 4), view(sph, 3*ns, ctypes.c_double).reshape(-1, 3)
		seed_site = lambda k: table_site(vt, st, k)
	else:
		seed_site = pix.site
	p = np.arange(n)
	if d_out:
		d = np.full(n, distances_core.BIG)
		ok = own >= 0
		d[ok] = angle(pix.site(p[ok]), seed_site(own[ok]))
		view(d_out, n, ctypes.c_double)[:] = d
		return
	y, x = p//nx, p % nx
	qy, qx = y - sy, x - (sx % nx if wrapx else sx)
	if wrapx: qx = np.where(qx < 0, qx + nx, qx)
	ok = (qy >= 0) & (qy < ny) & (qx >= 0) & (qx < nx)
	cand = np.where(ok, own[np.where(ok, qy*nx + qx, 0)], -1)
	best = own.copy()
	ev = (cand >= 0) & (cand != own)
	best[ev & (own < 0)] = cand[ev & (own < 0)]
	e = np.nonzero(ev & (own >= 0))[0]
	q, o, c = pix.site(e), seed_site(own[e]), seed_site(cand[e])
	dc, dn = dots(q, c), dots(q, o)
	take = dc > dn + margin
	tie = ~take & (dc >= dn - margin)
	if tie.any():
		TIES["jump_flood"] += int(tie.sum())
		take[tie] = angle(pick(q, tie), pick(c, tie)) < angle(pick(q, tie), pick(o, tie))
	best[e[take]] = cand[e[take]]
	view(seed_out, n, it)[:] = best


def emulate_nearest(dsc, dsy, dsx, ra, rcs, rsy, rsx, ny, nx, vec, sph, npt, margin, dist, dom):
	assert margin == M
	margin = EMU["margin"] or margin
	n = ny*nx
	pix = PixTab(ny, nx, dsc, dsy, dsx, ra, rcs, rsy, rsx)
	vt, st = view(vec, 4*npt, ctypes.c_double).reshape(-1, 4), view(sph, 3*npt, ctypes.c_double).reshape(-1, 3)
	p = np.arange(n)
	q = pix.site(p)
	y, x = p//nx, p % nx
	sep = (dsy, dsx, rsy, rsx) == (1, 0, 0, 1)
	i, j = y*dsy + x*dsx, y*rsy + x*rsx
	qf = (pix.dsc[i, 1], pix.dsc[i, 0], pix.rcs[j, 0], pix.rcs[j, 1])   # cos dec, sin dec, cos ra, sin ra
	# the thread each pixel is in: NEAR_R rows of a column on a separable
	# geometry, else pixels NEAR_BLOCK apart in a block's NEAR_R NEAR_BLOCK
	B, R, S = NEAR["NEAR_BLOCK"], NEAR["NEAR_R"], NEAR["NEAR_STEP"]
	thread = np.unique(y//R*nx + x if sep else p//(B*R)*B + p % B, return_inverse=True)[1]
	# per pixel as in the kernel: the best dot product, the threshold below
	# which a point is not looked at, the best point's angle (-1 before it
	# is needed) and index
	bd, thr, vb, bi = np.full(n, -4.0), np.full(n, -5.0), np.full(n, -1.0), np.full(n, -1)
	for j0 in range(0, npt, S):
		# the filter of a step (points past npt zero vectors), at the step's
		# thresholds: the thread goes through the step's points where one of
		# its pixels' values has its sign bit clear
		cs = np.zeros((3, S))
		cs[:, :min(S, npt - j0)] = vt[j0:j0 + S, :3].T
		f = near_filter(tuple(v[:, None] for v in qf), cs[:, None, :], thr[:, None], sep)
		step = (np.bincount(thread, (~np.signbit(f).all(1)).astype(float)) > 0)[thread]
		for j in range(j0, min(j0 + S, npt)):
			c = table_site(vt, st, np.full(n, j))
			d = dots(q, c)
			look = step & (d >= thr)
			new = look & ((d > bd + margin) | (bi < 0))   # bi < 0: the kernel's bd = -4 takes the first point
			tie = look & ~new
			vb = np.where(new, -1.0, vb)
			if tie.any():
				TIES["nearest_point"] += int(tie.sum())
				need = tie & (vb < 0)
				if need.any(): vb[need] = angle(pick(q, need), table_site(vt, st, bi[need]))
				v = np.full(n, np.inf)
				v[tie] = angle(pick(q, tie), pick(c, tie))
				won = tie & (v < vb)
				vb = np.where(won, v, vb)
				new = new | won
			bd, bi = np.where(new, d, bd), np.where(new, j, bi)
			thr = np.where(new, bd - margin, thr)
	out = np.full(n, distances_core.BIG)
	has = bi >= 0
	out[has] = vb[has]
	miss = has & (vb < 0)
	if miss.any(): out[miss] = angle(pick(q, miss), table_site(vt, st, bi[miss]))
	view(dist, n, ctypes.c_double)[:] = out
	if dom: view(dom, n, ctypes.c_int32)[:] = np.where(has, bi, 0)


@pytest.fixture
def on_card(monkeypatch):
	"""The wrappers' card path on CPU tensors, the launches emulated."""
	def call(name, device, *args):
		{"jump_flood": emulate_flood, "nearest_point": emulate_nearest}[name](*args)
		distances_cuda.LAUNCHES[name] += 1
	monkeypatch.setattr(distances_cuda, "_on_card", lambda x: True)
	monkeypatch.setattr(distances_cuda, "_call", call)
	distances_cuda.reset_launches()
	for k in TIES: TIES[k] = 0
	yield
	distances_cuda.reset_launches()


def by_angles(fn):
	"""fn() with the emulation deciding every comparison by the angles."""
	EMU["margin"] = np.inf
	try:
		return fn()
	finally:
		EMU["margin"] = None


def plain(fn):
	"""fn() through the plain versions (the wrappers' CPU path)."""
	on = distances_cuda._on_card
	distances_cuda._on_card = lambda x: False
	try:
		return fn()
	finally:
		distances_cuda._on_card = on


def equal(a, b):
	return all(torch.equal(getattr(x, "data", x), getattr(y, "data", y)) for x, y in zip(a, b))


def held(got, want):
	"""got = (seeds or domains, distances) against want: distances within TOL,
	seeds equal except at ties within TOL."""
	s1, d1 = (np.asarray(getattr(v, "data", v)) for v in got)
	s2, d2 = (np.asarray(getattr(v, "data", v)) for v in want)
	return np.max(np.abs(d1 - d2)) <= TOL and same_seeds(s1, s2, d1, d2)


def fullsky():
	return jenmap.fullsky_geometry(res=15*jutils.degree)          # 12 x 24, RA wrapped


def patch():
	return jenmap.geometry(pos=np.array([[-5, 5], [5, -5]])*jutils.degree, shape=(12, 24), proj="car")


def tan():
	return jenmap.geometry(pos=np.array([0.1, 0.2]), res=jutils.degree, shape=(12, 24), proj="tan")


def ref_flood(seed, dec_t, ra_t, lab, pdec, pra, wrapx, steps):
	"""The reference's _jump_flood from seeds at flat pixels seed with
	positions (dec_t, ra_t) and labels lab; (labels, distances)."""
	n = pdec.size
	sd, sr, sl = np.full(n, 1e30), np.zeros(n), np.full(n, -1.0)
	sd[seed], sr[seed], sl[seed] = dec_t, ra_t, lab
	with jax.disable_jit():
		ref = jdist._jump_flood(*(jax.numpy.asarray(a.reshape(pdec.shape)) for a in (sd, sr, sl)),
			jax.numpy.asarray(pdec), jax.numpy.asarray(pra), wrapx, steps)
	return np.asarray(ref[2]), np.asarray(ref[3])


def same_seeds(s1, s2, d1, d2):
	diff = np.asarray(s1) != np.asarray(s2)
	return np.all(np.abs(np.asarray(d1) - np.asarray(d2))[diff] <= TOL)


STEPS = (64, 50, 13, 7, 3, 2, 1)


@pytest.mark.parametrize("geo, table", [(fullsky, False), (fullsky, True), (patch, False), (patch, True),
	(tan, False), (tan, True)])
def test_emulated_flood(on_card, geo, table):
	"""The card path's flood (tables, strides, the margin): equal to its
	decisions by the angles alone, and held to the plain flood and to the
	reference's _jump_flood at its traps."""
	shape, wcs = geo()
	pd, pr = distances._positions(shape, wcs, "cpu")
	rng = np.random.default_rng(1)
	n = int(np.prod(shape))
	pick_ = rng.choice(n, 7, replace=False)
	full_d, full_r = pd.expand(shape).reshape(-1).numpy(), pr.expand(shape).reshape(-1).numpy()
	if table:
		tdec, tra = rng.uniform(-1.3, 1.3, 7), rng.uniform(-np.pi, np.pi, 7)
		tab, lab = (torch.from_numpy(tdec), torch.from_numpy(tra)), np.arange(7)
	else:
		tdec, tra, tab, lab = full_d[pick_], full_r[pick_], None, pick_
	seed = torch.full((n,), -1, dtype=torch.int32)
	seed[torch.from_numpy(pick_)] = torch.from_numpy(lab).to(torch.int32)
	seed = seed.reshape(shape)
	wrapx = distances._is_wrapx(shape, wcs)
	got = distances_cuda.jump_flood(seed, pd, pr, wrapx, STEPS, tab)
	assert distances_cuda.LAUNCHES["jump_flood"] == 8*len(STEPS) + 1
	assert torch.equal(seed.reshape(-1)[torch.from_numpy(pick_)], torch.from_numpy(lab).to(torch.int32))
	assert equal(got, by_angles(lambda: distances_cuda.jump_flood(seed, pd, pr, wrapx, STEPS, tab)))
	assert held(got, plain(lambda: distances_cuda.jump_flood(seed, pd, pr, wrapx, STEPS, tab)))
	assert held(got, ref_flood(pick_, tdec, tra, lab, full_d.reshape(shape), full_r.reshape(shape), wrapx, STEPS))


def test_emulated_flood_healpix(on_card):
	"""The HEALPix grid: a [ny, 1] dec table and a [ny, W] RA table."""
	nside = 4
	info = distances.healpix_info(nside)
	rng = np.random.default_rng(2)
	pts = np.array([np.arcsin(rng.uniform(-1, 1, 9)), rng.uniform(0, 2*np.pi, 9)])
	run = lambda: distances.distance_from_points_healpix(info, pts, domains=True, method="grid", device="cpu")
	got = run()
	assert distances_cuda.LAUNCHES["jump_flood"] == 8*len(distances._steps_for(4*nside)) + 1
	assert equal(got, by_angles(run))
	assert held(got[::-1], plain(run)[::-1])
	W = 4*nside
	t = distances_cuda.tables("t", torch.zeros(info.ny, 1, dtype=torch.float64),
		torch.zeros(info.ny, W, dtype=torch.float64), (info.ny, W), torch.device("cpu"))
	assert t.strides == (1, 0, W, 1)
	# the whole grid flood against the reference's on the same cells
	yg = np.arange(info.ny)[:, None]
	gdec = np.broadcast_to(info.dec[:, None], (info.ny, W))
	gra = info.ra0[yg] + (np.arange(W)[None, :]*info.nx[yg]//W)*(2*np.pi)/info.nx[yg]
	seed = torch.full((info.ny, W), -1, dtype=torch.int32)
	cells = rng.choice(info.ny*W, 9, replace=False)
	seed.view(-1)[torch.from_numpy(cells)] = torch.arange(9, dtype=torch.int32)
	steps = distances._steps_for(W)
	got = distances_cuda.jump_flood(seed, torch.from_numpy(info.dec[:, None].copy()), torch.from_numpy(gra),
		True, steps, (torch.from_numpy(pts[0]), torch.from_numpy(pts[1])))
	assert held(got, ref_flood(cells, pts[0], pts[1], np.arange(9), np.ascontiguousarray(gdec), gra, True, steps))


def test_emulated_flood_int64(on_card):
	shape, wcs = patch()
	n = int(np.prod(shape))
	pick_ = np.random.default_rng(3).choice(n, 5, replace=False)
	seed = torch.full((n,), -1, dtype=torch.int64)
	seed[torch.from_numpy(pick_)] = torch.from_numpy(pick_)
	pd, pr = distances._positions(shape, wcs, "cpu")
	s64, d64 = distances_cuda.jump_flood(seed.reshape(shape), pd, pr, False, (16, 4, 1))
	s32, d32 = distances_cuda.jump_flood(seed.reshape(shape).to(torch.int32), pd, pr, False, (16, 4, 1))
	assert s64.dtype == torch.int64 and torch.equal(s64, s32.to(torch.int64)) and torch.equal(d64, d32)
	assert held((s64, d64), plain(lambda: distances_cuda.jump_flood(seed.reshape(shape), pd, pr, False, (16, 4, 1))))


@pytest.mark.parametrize("geo", [fullsky, patch, tan])
def test_emulated_nearest_point(on_card, geo):
	"""The card path's brute force: equal to its decisions by the angles
	alone, held to the plain version and the reference's brute force."""
	shape, wcs = geo()
	rng = np.random.default_rng(4)
	pts = np.array([rng.uniform(-1.4, 1.4, 40), rng.uniform(-np.pi, np.pi, 40)])
	run = lambda: distances.distance_from_points(shape, wcs, pts, domains=True, device="cpu")
	d, dom = run()
	assert distances_cuda.LAUNCHES["nearest_point"] == 1
	assert equal((d, dom), by_angles(run))
	assert held((dom, d), plain(run)[::-1])
	assert held((dom, d), jdist.distance_from_points(shape, wcs, pts, domains=True)[::-1])
	d0, dom0 = distances_cuda.nearest_point(*distances._positions(shape, wcs, "cpu"), torch.zeros(0,
		dtype=torch.float64), torch.zeros(0, dtype=torch.float64), shape)
	assert torch.all(d0 == distances_core.BIG) and torch.all(dom0 == 0)


def near_ties(shape, wcs, rng, nmirror=20, npair=10):
	"""Points mirrored about pixel centres (in RA and in dec) and pairs
	1e-15 rad apart: [{dec, ra}, n]."""
	pos = enmap.posmap(shape, wcs, safe=False, device="cpu").data.numpy()
	ny, nx = shape
	y, x = rng.integers(2, ny - 2, nmirror), rng.integers(2, nx - 2, nmirror)
	k = rng.integers(1, 3, nmirror)
	c = pos[:, y, x]
	out = [np.array([c[0], c[1] + k*1e-2]), np.array([c[0], c[1] - k*1e-2]),
		np.array([c[0] + k*1e-2, c[1]]), np.array([c[0] - k*1e-2, c[1]])]
	a = np.array([rng.uniform(pos[0].min(), pos[0].max(), npair), rng.uniform(pos[1].min(), pos[1].max(), npair)])
	out += [a, a + np.array([1e-15, 0])[:, None], a + np.array([0, 1e-15])[:, None]]
	return np.concatenate(out, 1)


@pytest.mark.parametrize("geo", [fullsky, patch])
def test_emulated_near_ties(on_card, geo):
	"""The near-tie set: both kernels' emulations take the Vincenty branch,
	decide as the angles alone do, and hold to the plain versions."""
	shape, wcs = geo()
	rng = np.random.default_rng(5)
	pts = near_ties(shape, wcs, rng)
	run = lambda: distances.distance_from_points(shape, wcs, pts, domains=True, device="cpu")
	d, dom = run()
	assert TIES["nearest_point"] > 0
	assert equal((d, dom), by_angles(run))
	assert held((dom, d), plain(run)[::-1])
	# the flood from a seed table of the same points, each at its own pixel
	n = int(np.prod(shape))
	pd, pr = distances._positions(shape, wcs, "cpu")
	seed = torch.full((n,), -1, dtype=torch.int32)
	seed[torch.from_numpy(rng.choice(n, pts.shape[1], replace=False))] = torch.arange(pts.shape[1],
		dtype=torch.int32)
	tab = (torch.from_numpy(pts[0].copy()), torch.from_numpy(pts[1].copy()))
	wrapx = distances._is_wrapx(shape, wcs)
	run = lambda: distances_cuda.jump_flood(seed.reshape(shape), pd, pr, wrapx, STEPS, tab)
	got = run()
	assert TIES["jump_flood"] > 0
	assert equal(got, by_angles(run))
	assert held(got, plain(run))


@pytest.mark.parametrize("geo", [fullsky, patch, tan])
def test_tables(geo):
	"""The tables the kernels read: each the sin / cos of the positions in
	their own broadcast shape, read as [ny, nx] through the strides."""
	shape, wcs = geo()
	pd, pr = distances._positions(shape, wcs, "cpu")
	pts = (torch.tensor([0.1, -0.5], dtype=torch.float64), torch.tensor([2.0, -1.0], dtype=torch.float64))
	t = distances_cuda.tables("t", pd, pr, shape, torch.device("cpu"), pts)
	want = {"dec_sc": torch.stack([torch.sin(pd), torch.cos(pd)], -1), "ra": pr,
		"ra_cs": torch.stack([torch.cos(pr), torch.sin(pr)], -1)}
	for k, v in want.items():
		assert torch.equal(getattr(t, k), v.expand(getattr(t, k).shape)), k
	sep = pd.shape[1] == 1
	assert t.strides == ((1, 0, 0, 1) if sep else (shape[1], 1, shape[1], 1))
	assert t.dec_sc.stride()[:2] == (2*t.strides[0], 2*t.strides[1]) and t.dec_sc.stride(2) == 1
	assert t.ra_cs.stride()[:2] == (2*t.strides[2], 2*t.strides[3]) and t.ra.stride() == t.strides[2:]
	assert t.dec_sc.untyped_storage().nbytes() == 16*(shape[0] if sep else shape[0]*shape[1])
	assert t.vec.shape == (2, 4) and t.sph.shape == (2, 3) and t.vec.is_contiguous()
	assert torch.equal(t.vec[:, 2], torch.sin(pts[0])) and torch.equal(t.sph[:, 0], pts[1])
	assert torch.all(t.vec[:, 3] == 0)
	assert torch.allclose(t.vec.norm(dim=1), torch.ones(2, dtype=torch.float64), atol=1e-15)
	# a broadcast view as input keeps the table in its own shape
	t2 = distances_cuda.tables("t", pd.expand(shape), pr.expand(shape), shape, torch.device("cpu"))
	assert t2.strides == t.strides and torch.equal(t2.ra_cs, t.ra_cs)
