"""The redesigned float64 near-pole synthesis pass (pixell_tpu_torch.ops.
sht_cuda.polar_synthesis) on the CPU, where its plain PyTorch version stands
in for the CUDA kernel, held against pixell_tpu on the same numpy inputs:
the pass itself in all five modes, and the float32 dispatch that routes its
near-pole rings through it.

Tolerances, relative to the largest reference value:
- polar_synthesis in float64: 1e-10 (same recurrence, other summation order;
  the ring set holds both poles, where the spin modes take their limits);
- the float32 dispatch: 2e-5, the bound of tests/test_pallas.py for the
  float32 kernels (the near-pole rings run in float64).
The CUDA kernel (csrc/legendre.cu polar_synthesis_kernel) runs only on a
GPU; chip_smoke.py holds it against the plain version tested here.
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


def reference(A, theta, lmax, mmax, mode):
	if mode == "wigner":
		return np.asarray(jcore.wigner_synthesis_scan(jnp.asarray(A), theta, lmax, mmax, S))
	return np.asarray(jcore.synthesis_scan(jnp.asarray(A), theta, lmax, mmax, mode=mode,
		dtype=np.float64))


def relerr(x, ref):
	return np.abs(np.asarray(x) - ref).max()/np.abs(ref).max()


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_reference(mode):
	"""polar_synthesis on CPU tensors: [nl, nm, C] -> [nfun, C, nm, nt] in
	float64, with 6 columns (the kernel takes them as 4 + 2), against the
	reference scan; no kernel is launched."""
	theta = polar_rings()
	rng = np.random.default_rng(10 + MODES.index(mode))
	A = rng.standard_normal((LMAX + 1, MMAX + 1, 6))
	g = sht_cuda.geom(theta, MMAX, torch.float64, "cpu", spin_of(mode))
	G = sht_cuda.polar_synthesis(torch.from_numpy(A), g, LMAX, mode)
	assert G.shape == (sht_core.NFUN[mode], 6, MMAX + 1, len(theta)) and G.dtype == torch.float64
	assert relerr(G, reference(A, theta, LMAX, MMAX, mode)) <= 1e-10
	assert sht_cuda.LAUNCHES["polar_synthesis"] == 0
	# the same function as K3's plain version without stops
	assert torch.equal(G, sht_cuda.PLAIN["full_synthesis"](torch.from_numpy(A), g, LMAX, mode))


@pytest.mark.parametrize("mode,rings", [("scalar", "sym"), ("scalar", "asym"), ("spin2", "sym"),
	("spin2", "asym"), ("wigner", "asym")])
def test_dispatch_routes_polar_pass(mode, rings, monkeypatch):
	"""The float32 dispatch runs its bulk on K1 (a south-symmetric ring set)
	or K3 in float32, and overwrites its near-pole rings with polar_synthesis
	in float64, never with K3 in float64; the result still matches the
	reference (POLAR_AMP lowered so that lmax 24 has both kinds of rings)."""
	monkeypatch.setattr(sht_cuda, "POLAR_AMP", 4.0)
	rng = np.random.default_rng(9)
	if rings == "sym":
		theta = (np.arange(48) + 0.5)*np.pi/48
	else:
		theta = np.sort(np.concatenate([rng.uniform(0.02, 3.1, 46), [1e-3, np.pi - 2e-3]]))
	lmax, mmax = 24, 22
	nn, ns = sht_cuda.polar_counts(theta, lmax)
	assert nn > 0 and ns > 0 and nn + ns < len(theta)
	calls = []
	for name in ("full_synthesis", "sym_synthesis", "polar_synthesis"):
		kern = getattr(sht_cuda, name)
		def spy(x, g, *args, kern=kern, name=name, **kw):
			calls.append((name, g.dtype, g.nt))
			return kern(x, g, *args, **kw)
		monkeypatch.setattr(sht_cuda, name, spy)
	A = rng.standard_normal((lmax + 1, mmax + 1, 4))
	G = sht_cuda.kernel_synthesis(torch.from_numpy(A), theta, lmax, mmax, mode, torch.float32,
		spin_of(mode))
	assert G.dtype == torch.float32
	bulk = ("sym_synthesis", torch.float32, len(theta)//2) if rings == "sym" else \
		("full_synthesis", torch.float32, len(theta))
	assert calls == [bulk, ("polar_synthesis", torch.float64, nn + ns)]
	assert relerr(G.double(), reference(A, theta, lmax, mmax, mode)) <= 2e-5


def test_wrapper_checks():
	"""float64 only, the mode's shape, contiguous, no stop degrees or state,
	and no device but the CPU (plain version) or CUDA (kernel)."""
	theta = polar_rings()
	g64 = sht_cuda.geom(theta, 4, torch.float64, "cpu")
	g32 = sht_cuda.geom(theta, 4, torch.float32, "cpu")
	A = torch.zeros((7, 5, 4), dtype=torch.float64)
	assert sht_cuda.polar_synthesis(A, g64, 6, "spin2").shape == (2, 4, 5, len(theta))
	with pytest.raises(TypeError):
		sht_cuda.polar_synthesis(A.float(), g64, 6, "spin2")
	with pytest.raises(TypeError):
		sht_cuda.polar_synthesis(A.float(), g32, 6, "spin2")
	with pytest.raises(ValueError):   # nl is lmax + 1
		sht_cuda.polar_synthesis(A, g64, 7, "spin2")
	with pytest.raises(ValueError):   # nm is the geometry's
		sht_cuda.polar_synthesis(A[:, :4], g64, 6, "spin2")
	with pytest.raises(ValueError):
		sht_cuda.polar_synthesis(A[..., 0], g64, 6, "spin2")
	with pytest.raises(ValueError):
		sht_cuda.polar_synthesis(A.transpose(0, 1).contiguous().transpose(0, 1), g64, 6, "spin2")
	with pytest.raises(ValueError):
		sht_cuda.polar_synthesis(A, g64, 6, "spin3")
	with pytest.raises(TypeError):
		sht_cuda.polar_synthesis(A, g64, 6, "spin2", lstop=None)
	with pytest.raises(TypeError):
		sht_cuda.polar_synthesis(A, g64, 6, "spin2", dump_state=True)
	with pytest.raises(ValueError):   # a geometry prepared with a spin is the wigner mode's
		sht_cuda.polar_synthesis(A, sht_cuda.geom(theta, 4, torch.float64, "cpu", 3), 6, "spin2")
	gm = sht_cuda.geom(theta, 4, torch.float64, "meta")
	with pytest.raises(RuntimeError, match="no Legendre kernel"):
		sht_cuda.polar_synthesis(A.to("meta"), gm, 6, "spin2")
