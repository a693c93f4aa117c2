"""The redesigned float64 near-pole analysis pass (pixell_tpu_torch.ops.
sht_cuda.polar_analysis) on the CPU, where its plain PyTorch version stands
in for the CUDA kernel, held against pixell_tpu on the same numpy inputs:
the pass itself in all five modes, and the float32 dispatch that routes its
near-pole rings through it.

Tolerances, relative to the largest reference value:
- polar_analysis in float64: 1e-10 (same recurrence, other summation order;
  the ring set holds both poles, where the spin modes take their limits);
- the float32 dispatch: 2e-5, the bound of tests/test_pallas.py for the
  float32 kernels (the near-pole rings run in float64).
The CUDA kernel (csrc/legendre.cu polar_analysis_kernel) runs only on a GPU;
chip_smoke.py holds it against the plain version tested here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax.numpy as jnp

from pixell_tpu.ops import sht_core as jcore
from pixell_tpu_torch.ops import sht_cuda, sht_core

LMAX, MMAX, S = 40, 29, 3      # 30 m rows: not a multiple of any tiling
MODES = ["scalar", "deriv", "spin1", "spin2", "wigner"]


def polar_rings():
	"""The 9 rings nearest each pole of a 101-ring Clenshaw-Curtis grid, the
	poles themselves included."""
	th = np.arange(101)*np.pi/100
	return np.concatenate([th[:9], th[-9:]])


def spin_of(mode):
	return S if mode == "wigner" else None


def reference(F, theta, lmax, mmax, mode):
	if mode == "wigner":
		return np.asarray(jcore.wigner_analysis_scan(jnp.asarray(F), theta, lmax, mmax, S))
	return np.asarray(jcore.analysis_scan(jnp.asarray(F), theta, lmax, mmax, mode=mode,
		dtype=np.float64))


def relerr(x, ref):
	return np.abs(np.asarray(x) - ref).max()/np.abs(ref).max()


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_reference(mode):
	"""polar_analysis on CPU tensors: [nfun, C, nm, nt] -> [nl, nm, C] in
	float64, with 6 columns (the kernel takes them as 4 + 2), against the
	reference scan; no kernel is launched."""
	theta = polar_rings()
	nfun = sht_core.NFUN[mode]
	rng = np.random.default_rng(MODES.index(mode))
	F = rng.standard_normal((nfun, 6, MMAX + 1, len(theta)))
	g = sht_cuda.geom(theta, MMAX, torch.float64, "cpu", spin_of(mode))
	a = sht_cuda.polar_analysis(torch.from_numpy(F), g, LMAX, mode)
	assert a.shape == (LMAX + 1, MMAX + 1, 6) and a.dtype == torch.float64
	assert relerr(a, reference(F, theta, LMAX, MMAX, mode)) <= 1e-10
	assert sht_cuda.LAUNCHES["polar_analysis"] == 0
	# the same function as K4's plain version without stops
	assert torch.equal(a, sht_cuda.PLAIN["full_analysis"](torch.from_numpy(F), g, LMAX, mode))


@pytest.mark.parametrize("mode", ["scalar", "spin2", "wigner"])
def test_dispatch_routes_polar_pass(mode, monkeypatch):
	"""The float32 dispatch runs its bulk rings through K2/K4 in float32 and
	its near-pole rings through polar_analysis in float64, never through K4
	in float64, and still matches the reference (POLAR_AMP lowered so that
	lmax 24 has both kinds of rings)."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	rng = np.random.default_rng(8)
	theta = np.sort(np.concatenate([rng.uniform(0.02, 3.1, 46), [1e-3, np.pi - 2e-3]]))
	lmax, mmax = 24, 22
	nn, ns = sht_cuda.polar_counts(theta, lmax)
	assert nn > 0 and ns > 0 and nn + ns < len(theta)
	calls = []
	for name in ("full_analysis", "sym_analysis", "polar_analysis"):
		kern = getattr(sht_cuda, name)
		def spy(x, g, *args, kern=kern, name=name, **kw):
			calls.append((name, g.dtype, g.nt))
			return kern(x, g, *args, **kw)
		monkeypatch.setattr(sht_cuda, name, spy)
	nfun = sht_core.NFUN[mode]
	F = rng.standard_normal((nfun, 4, mmax + 1, len(theta)))
	a = sht_cuda.kernel_analysis(torch.from_numpy(F), theta, lmax, mmax, mode, torch.float32,
		spin_of(mode))
	assert a.dtype == torch.float32
	assert calls == [("full_analysis", torch.float32, len(theta) - nn - ns),
		("polar_analysis", torch.float64, nn + ns)]
	assert relerr(a.double(), reference(F, theta, lmax, mmax, mode)) <= 2e-5


def test_wrapper_checks():
	"""float64 only, the mode's shape, contiguous, no stop degrees or state,
	and no device but the CPU (plain version) or CUDA (kernel)."""
	theta = polar_rings()
	g64 = sht_cuda.geom(theta, 4, torch.float64, "cpu")
	g32 = sht_cuda.geom(theta, 4, torch.float32, "cpu")
	F = torch.zeros((2, 4, 5, len(theta)), dtype=torch.float64)
	assert sht_cuda.polar_analysis(F, g64, 6, "spin2").shape == (7, 5, 4)
	with pytest.raises(TypeError):
		sht_cuda.polar_analysis(F.float(), g64, 6, "spin2")
	with pytest.raises(TypeError):
		sht_cuda.polar_analysis(F.float(), g32, 6, "spin2")
	with pytest.raises(ValueError):   # spin2 takes two mode functions
		sht_cuda.polar_analysis(F[:1], g64, 6, "spin2")
	with pytest.raises(ValueError):
		sht_cuda.polar_analysis(F[..., :-1], g64, 6, "spin2")
	with pytest.raises(ValueError):
		sht_cuda.polar_analysis(F.transpose(0, 1).contiguous().transpose(0, 1), g64, 6, "spin2")
	with pytest.raises(TypeError):
		sht_cuda.polar_analysis(F, g64, 6, "spin2", lstop=None)
	with pytest.raises(TypeError):
		sht_cuda.polar_analysis(F, g64, 6, "spin2", dump_state=True)
	with pytest.raises(ValueError):   # a geometry prepared with a spin is the wigner mode's
		sht_cuda.polar_analysis(F, sht_cuda.geom(theta, 4, torch.float64, "cpu", 3), 6, "spin2")
	gm = sht_cuda.geom(theta, 4, torch.float64, "meta")
	with pytest.raises(RuntimeError, match="no Legendre kernel"):
		sht_cuda.polar_analysis(F.to("meta"), gm, 6, "spin2")
