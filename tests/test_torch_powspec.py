"""pixell_tpu_torch.powspec against pixell_tpu.powspec: the symmetric
packing, the C_l / D_l scaling, the CAMB-style readers and writers on files
written to tmp_path, the lensing-potential helpers and spec2corr. Both are
host numpy doing the same operations, so they agree exactly, spec2corr
(a Legendre recurrence summed in the same order) within 1e-12 of its
largest value. No JAX array is involved.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import powspec as jpowspec
from pixell_tpu_torch import powspec

NL = 50


def camb_columns(ncol, seed=0, lmin=2):
	"""[l, c1, ..., c_ncol] rows from lmin to NL-1, D_l-like positive values."""
	rng = np.random.default_rng(seed)
	l = np.arange(lmin, NL, dtype=float)
	return np.concatenate([l[:, None], rng.uniform(1, 100, (l.size, ncol))], 1)


def equal(a, b):
	np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scheme", [None, "standard", "diag"])
@pytest.mark.parametrize("n", [1, 3, 6, 10])
def test_symmetric_packing(scheme, n):
	assert powspec.compressed_order(n, scheme) == jpowspec.compressed_order(n, scheme)
	rng = np.random.default_rng(n)
	m = rng.standard_normal((n, NL))
	full = powspec.sym_expand(m, scheme=scheme)
	equal(full, jpowspec.sym_expand(m, scheme=scheme))
	equal(full, np.swapaxes(full, 0, 1))
	equal(powspec.sym_compress(full, scheme=scheme), jpowspec.sym_compress(full, scheme=scheme))
	if scheme != "diag": equal(powspec.sym_compress(full, scheme=scheme), m)


@pytest.mark.parametrize("direction", [1, -1, 2])
def test_scale_spectrum(direction):
	ps = np.random.default_rng(1).uniform(1, 2, (3, NL))
	equal(powspec.scale_spectrum(ps, direction), jpowspec.scale_spectrum(ps, direction))
	l = np.arange(NL) + 0.5
	equal(powspec.scale_spectrum(ps, direction, extra=1, l=l), jpowspec.scale_spectrum(ps, direction, extra=1, l=l))


@pytest.mark.parametrize("expand", [None, "diag", "standard"])
@pytest.mark.parametrize("scale", [True, False])
def test_read_write_spectrum(tmp_path, expand, scale):
	fname = str(tmp_path/"spec.txt")
	np.savetxt(fname, camb_columns(3))
	for inds in (True, False):
		got = powspec.read_spectrum(fname, inds=inds, scale=scale, expand=expand)
		equal(got, jpowspec.read_spectrum(fname, inds=inds, scale=scale, expand=expand))
	spec = powspec.read_spectrum(fname, scale=scale, expand=expand)
	out1, out2 = str(tmp_path/"w1.txt"), str(tmp_path/"w2.txt")
	powspec.write_spectrum(out1, spec, scale=scale, expand=expand or "diag")
	jpowspec.write_spectrum(out2, spec, scale=scale, expand=expand or "diag")
	assert open(out1).read() == open(out2).read()


def test_camb_readers(tmp_path):
	scal, lens = str(tmp_path/"scalCls.dat"), str(tmp_path/"lensedCls.dat")
	np.savetxt(scal, camb_columns(5, seed=2))
	np.savetxt(lens, camb_columns(4, seed=3))
	for expand in (True, False):
		equal(powspec.read_camb_scalar(scal, expand=expand), jpowspec.read_camb_scalar(scal, expand=expand))
		equal(powspec.read_camb_full_lens(lens, expand=expand), jpowspec.read_camb_full_lens(lens,
			expand=expand))
	for kw in (dict(), dict(coloff=1, scale=False), dict(expand=None)):
		equal(powspec.read_phi_spectrum(scal, **kw), jpowspec.read_phi_spectrum(scal, **kw))
	a = np.random.default_rng(4).uniform(1, 2, (7, NL))
	equal(powspec.sym_expand_camb_full_lens(a), jpowspec.sym_expand_camb_full_lens(a))
	for d in (1, -1):
		equal(powspec.scale_camb_scalar_phi(a[0], d), jpowspec.scale_camb_scalar_phi(a[0], d))
	x, y = np.array([0, 3, 7]), a[:2, :3]
	equal(powspec.expand_inds(x, y), jpowspec.expand_inds(x, y))


@pytest.mark.parametrize("iscos", [False, True])
def test_spec2corr(iscos):
	ps = np.random.default_rng(5).uniform(0, 1, (2, 2, 30))/(1 + np.arange(30))**2
	pos = np.linspace(0, np.pi, 17)
	x = np.cos(pos) if iscos else pos
	got = powspec.spec2corr(ps, x, iscos=iscos)
	want = jpowspec.spec2corr(ps, x, iscos=iscos)
	assert got.shape == want.shape
	assert np.abs(got - want).max() <= 1e-12*np.abs(want).max()
