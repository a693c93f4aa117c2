"""pixell_tpu_torch.utils' names of pixell_tpu/utils.py:17-1034 (the
constants through DataMissing) against the reference on the same numpy
inputs: constants and integer results exactly, float results within 1e-12
relative (float64), the Fourier interpolator within the NUFFT's own bound
(1e-10); the functions the reference runs on jnp or numpy (_xp) also on
tensors, which stay on their device. Then scripts.benchmark_main on the
CPU at a small size, and bench against the reference's own sequence
(tests/test_support.py:71-80)."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import utils as jutils, bench as jbench
from pixell_tpu_torch import utils, bench, scripts

REL = 1e-12


def rel(got, want):
	got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	want = np.asarray(want)
	assert got.shape == want.shape, (got.shape, want.shape)
	scale = np.abs(want).max()
	return np.abs(got - want).max()/(scale if scale else 1)


def test_constants_exact():
	names = ["degree", "arcmin", "arcsec", "fwhm", "T_cmb", "c", "h", "k", "e", "G", "sb", "day2sec", "yr2days",
		"minute", "hour", "day", "yr", "ly", "AU", "pc", "Jy", "hbar", "sigma_T", "sigma_sb", "m_e", "m_p", "m_n",
		"r_l1", "r_L2", "a", "adeg", "amin", "asec"]
	names += [p + b for b in ("sun", "mercury", "venus", "earth", "moon", "mars", "jupiter", "saturn", "uranus",
		"neptune", "pluto") for p in ("R_", "M_", "r_")] + ["L_sun"]
	for n in names:
		r, p = getattr(jutils, n), getattr(utils, n)
		assert type(p) is type(r) and np.array_equal(p, r), n


def test_small_helpers():
	for v in (2.3, -2.3, 4.0, -0.5):
		assert (utils.ceil(v), utils.floor(v)) == (jutils.ceil(v), jutils.floor(v))
	assert utils.first_importable("no_such_module_x", "numpy", "scipy") == "numpy"
	assert utils.first_importable("no_such_module_x") is None
	a = np.array([3, 1, 4, 1, 5])
	for ep in (False, True):
		np.testing.assert_array_equal(utils.cumsum(a, ep), jutils.cumsum(a, ep))
	ang = np.linspace(-10, 10, 41)
	for rng_ in ([0.5, 2.0], [-3.5, -1.0], [2.5, 4.0]):
		want = jutils.between_angles(ang, rng_)
		np.testing.assert_array_equal(utils.between_angles(ang, rng_), want)
		np.testing.assert_array_equal(utils.between_angles(torch.from_numpy(ang), rng_).numpy(), want)
	for a_, b_ in ((17, 4), (-17, 4), (18, 4), (np.arange(10), 3)):
		np.testing.assert_array_equal(utils.nint_div(a_, b_), jutils.nint_div(a_, b_))
	for dt in (np.float32, "f8", int):
		assert utils.fix_dtype(dt) == jutils.fix_dtype(dt)
	assert utils.fix_dtype(torch.float32) is torch.float32
	with pytest.raises(utils.DataError):
		raise utils.DataMissing("x")
	assert issubclass(utils.DataMissing, utils.DataError) and issubclass(utils.DataError, Exception)


def test_device_transfers():
	x = np.arange(6.0).reshape(2, 3) + 1j
	t = utils.to_device(x, device="cpu")
	assert isinstance(t, torch.Tensor) and t.dtype == torch.complex128
	np.testing.assert_array_equal(utils.from_device(t), x)
	assert utils.to_device(x, np.complex64, device="cpu").dtype == torch.complex64
	assert utils.to_device(t, torch.complex64, device="cpu").dtype == torch.complex64
	np.testing.assert_array_equal(utils.from_device(x.real), x.real)


def test_binning():
	for n, kw in ((100, {}), (1000, dict(nbin=7)), (50, dict(bsize=6)), (77, dict(nmin=10))):
		np.testing.assert_array_equal(utils.linbin(n, **kw), jutils.linbin(n, **kw))
	for n, kw in ((1000, {}), (5000, dict(nbin=30, nmin=4)), (300, dict(nmax=40)), (2000, dict(nmin=0))):
		np.testing.assert_array_equal(utils.expbin(n, **kw), jutils.expbin(n, **kw))
	d = np.random.default_rng(1).standard_normal((3, 200))
	bins = jutils.linbin(200, nbin=9)
	for op in (np.mean, np.max):
		np.testing.assert_array_equal(utils.bin_data(bins, d, op), jutils.bin_data(bins, d, op))


def test_interpol():
	rng = np.random.default_rng(2)
	a = rng.standard_normal((2, 12, 17))
	inds = rng.uniform(-1, 18, (2, 40))
	for order, mode in ((3, "nearest"), (1, "cyclic"), (0, "nearest"), (3, "constant")):
		want = np.asarray(jutils.interpol(a, inds, order=order, mode=mode))
		assert rel(utils.interpol(a, inds, order=order, mode=mode), want) <= REL
		assert rel(utils.interpol(torch.from_numpy(a), torch.from_numpy(inds), order=order, mode=mode),
			want) <= REL


def test_beams_and_solve():
	l = np.arange(3000.0)
	want = jutils.gauss_beam(l, 1.4*jutils.arcmin)
	assert rel(utils.gauss_beam(l, 1.4*utils.arcmin), want) <= REL
	assert rel(utils.gauss_beam(torch.from_numpy(l), 1.4*utils.arcmin), want) <= REL
	for sigma, phi in (((2.0, 1.0), 0.3), ((1.0, 3.0), -1.1)):
		c = utils.compress_beam(sigma, phi)
		assert rel(c, jutils.compress_beam(sigma, phi)) <= REL
		for rv in (False, True):
			got, want = utils.expand_beam(c, rv), jutils.expand_beam(c, rv)
			for g, w in zip(got, want): assert rel(g, w) <= REL
	bl = np.exp(-0.5*(np.arange(400)/80.0)**2)
	for kw in ({}, dict(cutoff=0.05, nl=600), dict(normalize=True, nl=300), dict(cutoff=2.0)):
		np.testing.assert_array_equal(utils.regularize_beam(bl*3 if kw.get("normalize") else bl, **kw),
			jutils.regularize_beam(bl*3 if kw.get("normalize") else bl, **kw))
	rng = np.random.default_rng(3)
	B = rng.standard_normal((3, 3, 5))
	A = np.einsum("ikn,jkn->ijn", B, B) + np.eye(3)[:, :, None]
	b = rng.standard_normal((3, 5))
	want = np.asarray(jutils.solve(A, b))
	assert rel(utils.solve(A, b), want) <= 1e-10
	assert rel(utils.solve(torch.from_numpy(A), torch.from_numpy(b)), want) <= 1e-10


def test_spectra():
	f = np.array([30e9, 90e9, 150e9, 220e9, 545e9])
	for fun, args in ((("planck", (f,)), ("planck", (f, 10.0)), ("dplanck", (f,)), ("graybody", (f,)),
			("graybody", (f, 20.0, 1.6)), ("blackbody", (f, 5.0)), ("tsz_spectrum", (f,)),
			("flux_factor", (1e-7, f)))):
		want = np.asarray(getattr(jutils, fun)(*args))
		assert rel(getattr(utils, fun)(*args), want) <= REL, fun
		targs = tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args)
		got = getattr(utils, fun)(*targs)
		assert isinstance(got, torch.Tensor) and rel(got, want) <= REL, fun


def test_printer(capsys):
	for mod in (utils, jutils):
		p = mod.Printer(level=2, prefix="a:")
		p.write("one")
		p.write("two", level=3)
		p.write("three", level=2, exact=True)
		p.write("four", level=1, exact=True)
		p.push("b:").write("five", newline=False)
		with p.time("six"):
			pass
	out = capsys.readouterr().err
	port, ref = out[:len(out)//2], out[len(out)//2:]
	assert port.replace(ref, "") == "" and port == ref
	assert "a:one\n" in port and "two" not in port and "four" not in port and "a:b:five" in port
	assert port.endswith(" six\n")


def test_fftlog():
	prof = lambda r: np.exp(-0.5*(r/2.0)**2)
	for kw in (dict(lmin=0.1, lmax=1e4, n=256, pad=64), dict(n=128, pad=32)):
		for g, w in zip(utils.profile_to_tform_hankel(prof, **kw), jutils.profile_to_tform_hankel(prof, **kw)):
			assert rel(g, w) <= REL
	for kw in (dict(xrange=[1e-3, 1e3], n=200, pad=20), dict(krange=[0.01, 100], n=128, bias=0.3)):
		a, b = utils.FFTLog(**kw), jutils.FFTLog(**kw)
		assert rel(a.x, b.x) <= REL and rel(a.k, b.k) <= REL
		f = lambda x: x**2*np.exp(-x)
		fa, fb = a.fft(f), b.fft(f)
		assert rel(fa, fb) <= REL
		assert rel(a.ifft(fa), b.ifft(fb)) <= REL
		assert rel(a.unpad(a.x), b.unpad(b.x)) <= REL
		ua, ub = a.unpad(a.x, a.k), b.unpad(b.x, b.k)
		for g, w in zip(ua, ub): assert rel(g, w) <= REL
	with pytest.raises(ValueError):
		utils.FFTLog()


def test_interpolators():
	rng = np.random.default_rng(4)
	ny, nx = 24, 32
	y, x = np.mgrid[:ny, :nx]
	data = np.cos(2*np.pi*3*y/ny) + np.sin(2*np.pi*(2*x/nx + 5*y/ny)) + 0.1*rng.standard_normal((ny, nx))
	box = np.array([[-1.0, 2.0], [3.0, 10.0]])
	coords = np.array([rng.uniform(-1, 3, 50), rng.uniform(2, 10, 50)])
	pix = np.array([rng.uniform(0, ny, 50), rng.uniform(0, nx, 50)])
	for b, c in ((box, coords), (None, pix)):
		for mode in ("spline", "linear", "cubic", "conv"):
			want = np.asarray(jutils.interpolator(data, b, mode=mode)(c))
			ip = utils.interpolator(data, b, mode=mode, device="cpu")
			assert rel(ip(c), want) <= REL, mode
			assert rel(ip(torch.from_numpy(c)), want) <= REL, mode
		want = np.asarray(jutils.FourierInterpolator(data, b)(c))
		got = utils.interpolator(torch.from_numpy(data), b, mode="fourier")(c)
		assert isinstance(got, torch.Tensor) and rel(got, want) <= 1e-10
		assert rel(utils.FourierInterpolator(data, b, device="cpu")(c), want) <= 1e-10
	with pytest.raises(ValueError):
		utils.interpolator(data, mode="nonsense")


def test_files_and_medmean(tmp_path):
	obj = {"a": np.arange(3), "b": "x"}
	utils.dump(str(tmp_path/"p.pkl"), obj)
	back = pickle.load(open(tmp_path/"p.pkl", "rb"))
	assert back["b"] == "x" and np.array_equal(back["a"], obj["a"])
	arr = np.random.default_rng(5).standard_normal((7, 3))
	np.savetxt(tmp_path/"t.txt", arr)
	np.testing.assert_array_equal(utils.loadtxt(str(tmp_path/"t.txt")), jutils.loadtxt(str(tmp_path/"t.txt")))
	v = np.random.default_rng(6).standard_normal(1001)
	for frac in (0.5, 0.2, 1.0):
		want = jutils.medmean(v, frac)
		assert utils.medmean(v, frac) == want
		assert abs(float(utils.medmean(torch.from_numpy(v), frac)) - want) <= REL*abs(want)


def test_tsz_profiles():
	x = np.array([0.01, 0.1, 0.5, 1.0, 2.0, 5.0])
	kw = dict(xc=0.4, alpha=1.1, beta=4.0, gamma=-0.2)
	assert rel(utils.tsz_profile_raw(x), jutils.tsz_profile_raw(x)) <= REL
	assert rel(utils.tsz_profile_raw(torch.from_numpy(x), **kw), jutils.tsz_profile_raw(x, **kw)) <= REL
	assert rel(utils.tsz_profile_los(x), jutils.tsz_profile_los(x)) <= REL
	assert rel(utils.tsz_profile_los(x, npoint=100, **kw), jutils.tsz_profile_los(x, npoint=100, **kw)) <= REL
	assert rel(utils.tsz_profile_los_fast(x), jutils.tsz_profile_los_fast(x)) <= REL


def test_benchmark_main_small(monkeypatch, capsys):
	"""The install benchmark at lmax 16 on the 6-degree full sky, 3 timed
	roundtrips (its size set through the module's constants)."""
	monkeypatch.setattr(scripts, "LMAX", 16)
	monkeypatch.setattr(scripts, "RES_ARCMIN", 360.0)
	monkeypatch.setattr(scripts, "NROUND", 3)
	t = scripts.benchmark_main()
	lines = capsys.readouterr().out.strip().splitlines()
	assert t > 0
	assert lines[0] == "Benchmarking SHTs on cpu (float64)"
	assert lines[1].startswith("3 x (map2alm lmax=16 + alm2map) on 30x60:") and lines[1].endswith("ms each)")


def test_bench_sequence():
	"""The reference's test_bench_module sequence gives the same counts."""
	import time
	res = []
	for mod in (jbench, bench):
		b = mod.Bench(sync=False)
		with b.mark("x"):
			sum(range(1000))
		res.append((b.n["x"], b.t_tot["x"] >= 0, b.t["x"] >= 0, "x" in b.n, len(b.t)))
		b.set_verbose(False)
		b.set_tfun(time.perf_counter)
		with b.mark("x"):
			pass
		b.add("y", 0.5)
		res.append((b.n["x"], b.n.get("y"), b.t_tot["y"], b.stats("y").tot, len(b.summary().splitlines())))
	assert res[:2] == res[2:]
	assert res[1][0] == 2
	# the module's default instance: live views
	bench.add("z", 1.0)
	assert bench.n["z"] >= 1 and bench.t["z"] == 1.0
	with bench.mark("w"):
		pass
	assert bench.n.get("w") >= 1
	bench.device_sync()   # no CUDA here: nothing to wait for


def test_enmap_last_names_and_seed_log():
	"""enmap's last six names and ops.sht_core.seed_log against the
	reference: posmap_old and posmap_jax (the separable posmap on a device)
	exactly, to_flipper raising ImportError without flipper (as the
	reference's), from_flipper of liteMap-like objects, fix_python3,
	wrapsutils_is_plain; seed_log bit for bit."""
	import types
	from pixell_tpu import enmap as jenmap
	from pixell_tpu.ops import sht_core as jsht_core
	from pixell_tpu_torch import enmap
	from pixell_tpu_torch.ops import sht_core
	for res, corner in ((10, False), (6, True)):
		shape, wcs = jenmap.fullsky_geometry(res=res*jutils.degree)
		pshape, pwcs = enmap.fullsky_geometry(res=res*utils.degree)
		want = np.asarray(jenmap.posmap_jax(shape, wcs, corner=corner))
		got = enmap.posmap_jax(pshape, pwcs, corner=corner, device="cpu")
		assert isinstance(got, enmap.ndmap)
		np.testing.assert_array_equal(got.data.numpy(), want)
		np.testing.assert_array_equal(enmap.posmap_old(pshape, pwcs, corner=corner, device="cpu").data.numpy(),
			np.asarray(jenmap.posmap_old(shape, wcs, corner=corner)))
	m = enmap.zeros((2,) + tuple(pshape), pwcs, device="cpu")
	for call in (lambda: enmap.to_flipper(m), lambda: m.to_flipper()):
		with pytest.raises(ImportError):
			call()
	with pytest.raises(ImportError):
		jenmap.to_flipper(jenmap.zeros((2,) + tuple(shape), wcs))
	lite = [types.SimpleNamespace(data=np.full(tuple(pshape), float(i)), wcs=pwcs) for i in range(3)]
	fm = enmap.from_flipper(lite, device="cpu")
	assert fm.shape == (3,) + tuple(pshape) and fm.wcs is pwcs
	np.testing.assert_array_equal(fm.data[:, 0, 0].numpy(), [0, 1, 2])
	assert enmap.fix_python3(b"abc") == jenmap.fix_python3(b"abc") == "abc"
	assert enmap.fix_python3(5) == 5
	assert enmap.wrapsutils_is_plain(pwcs) == jenmap.wrapsutils_is_plain(wcs) is False
	for mmax in (0, 1, 17, 300):
		for dt in (np.float64, np.float32):
			for g, w in zip(sht_core.seed_log(mmax, dt), jsht_core.seed_log(mmax, dt)):
				assert g.dtype == w.dtype
				np.testing.assert_array_equal(g, w)
