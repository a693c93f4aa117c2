"""The recurrence tables the Legendre kernels read (sht_cuda.coef_tables,
wigner_tables, l_tables) on the CPU: bit-identical to the numpy evaluation
of their formulas (sht_core.recur_ab, recur_e, wigner_abc, l_norms), in
float32 and float64, at nl 2001 and nm 128, a size whose torch evaluation
would be split over threads. numpy's sqrt and divide are correctly
rounded; torch's CPU sqrt is not always. The tables are built again in a
fresh process, where no cached table can stand in for the first build.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu_torch.ops import sht_cuda

NL, NM, SPIN = 2001, 128, 3


def want_coef(ndt):
	l = np.arange(NL, dtype=ndt)[:, None]
	m = np.arange(NM, dtype=ndt)[None, :]
	one, quarter = ndt(1), ndt(0.25)
	a = np.sqrt(np.maximum((2*l - one)*(2*l + one), 0)/np.maximum((l - m)*(l + m), quarter))
	b = np.sqrt(np.maximum((l - one - m)*(l - one + m), 0)/np.maximum((2*l - 3)*(2*l - one), one))
	e = np.sqrt(np.maximum((l - m)*(l + m)*(2*l + one), 0)/np.maximum(2*l - one, one))
	return np.stack([a, b, e]).astype(ndt)


def want_wigner(ndt):
	l = np.arange(NL, dtype=np.float64)[:, None]
	m = np.arange(NM, dtype=np.float64)[None, :]
	s = float(SPIN)
	v = lambda lv: np.sqrt(np.maximum((lv - m)*(lv + m)*(lv - s)*(lv + s), 0)) \
		/ np.maximum(lv*np.sqrt(np.maximum(4*lv*lv - 1, 0)), 1)
	live = l > np.maximum(m, s)
	vl = v(l)
	a = np.where(vl > 0, 1/np.maximum(vl, 1e-30), 0)
	c = m*s/np.maximum((l - 1)*l, 1)
	return np.stack([np.where(live, t, 0) for t in (a, v(l - 1), c)]).astype(ndt)


def want_norms(mode, ndt):
	l = np.arange(NL, dtype=ndt)
	if mode == "deriv": nrm = np.sqrt(np.maximum(l*(l + 1), 0))
	elif mode == "spin1": nrm = 1/np.sqrt(np.maximum(l*(l + 1), 1))
	else: nrm = 1/np.sqrt(np.maximum((l - 1)*l*(l + 1)*(l + 2), 1))
	return np.stack([nrm, np.sqrt((2*l + 1)/ndt(4*np.pi))/2]).astype(ndt)


def check_tables():
	"""Every table against its numpy evaluation, bit for bit."""
	for dt, ndt in ((torch.float32, np.float32), (torch.float64, np.float64)):
		got = sht_cuda.coef_tables(NL, NM, dt)
		assert got.dtype == dt
		np.testing.assert_array_equal(got.numpy(), want_coef(ndt))
		np.testing.assert_array_equal(sht_cuda.wigner_tables(NL, NM, SPIN, dt).numpy(), want_wigner(ndt))
		for mode in ("deriv", "spin1", "spin2"):
			np.testing.assert_array_equal(sht_cuda.l_tables(NL, mode, dt).numpy(), want_norms(mode, ndt))
		# and what the kernel launches read, through the cache
		np.testing.assert_array_equal(sht_cuda._coef_cached(NL, NM, dt, torch.device("cpu")).numpy(),
			want_coef(ndt))


def test_tables_are_numpys():
	check_tables()
	# a_lm in float64 against Python's correctly rounded math.sqrt, on a sample
	a = sht_cuda.coef_tables(NL, NM, torch.float64)[0].numpy()
	rng = np.random.default_rng(0)
	for l, m in zip(rng.integers(1, NL, 200), rng.integers(0, NM, 200)):
		if l < m: continue
		want = math.sqrt(float((2*l - 1)*(2*l + 1))/max(float((l - m)*(l + m)), 0.25))
		assert a[l, m] == want, (l, m)


def test_tables_in_a_fresh_process():
	root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
	code = ("import sys; sys.path[:0] = [%r, %r]; import test_torch_tables as t; t.check_tables(); "
		"print('ok')" % (root, os.path.join(root, "tests")))
	r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
		cwd=root)
	assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr
