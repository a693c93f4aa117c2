"""Iterative solvers as plain torch loops (counterpart of
pixell_tpu/ops/solvers.py).

The reference runs the whole solve in one XLA computation (lax.while_loop
and lax.fori_loop over pytrees). Here the loop is Python and every vector
stays on its device: a vector is a tensor, or a list, tuple or dict of
tensors (nested), as the reference's pytrees. The stopping test of
cg_solve reads one scalar from the device an iteration; no vector goes to
the host.
"""
from __future__ import annotations
import torch


def _leaves(x):
	"""The tensors of a vector, in a fixed order."""
	if isinstance(x, dict): return [leaf for key in sorted(x) for leaf in _leaves(x[key])]
	if isinstance(x, (list, tuple)): return [leaf for v in x for leaf in _leaves(v)]
	return [x]


def _map(f, *xs):
	"""f applied leaf by leaf to vectors of one structure."""
	x0 = xs[0]
	if isinstance(x0, dict): return {key: _map(f, *(x[key] for x in xs)) for key in x0}
	if isinstance(x0, (list, tuple)): return type(x0)(_map(f, *v) for v in zip(*xs))
	return f(*xs)


def _default_dot(a, b):
	"""sum Re(conj(a) b) over every leaf, a 0-d tensor on their device."""
	return sum(torch.sum((torch.conj(x)*y).real) for x, y in zip(_leaves(a), _leaves(b)))


def cg_solve(A, b, x0=None, M=None, tol=1e-8, maxiter=500, dot=None):
	"""Preconditioned conjugate gradients for A x = b, A symmetric positive
	definite (pixell_tpu.ops.solvers.cg_solve): A and M (the
	preconditioner, identity by default) are callables on vectors. Stops
	after maxiter iterations or once r.M(r) has fallen below tol^2 of its
	start. Returns (x, info), info = dict(iters, err) with err the square
	root of that ratio (a 0-d tensor)."""
	if dot is None: dot = _default_dot
	if M is None: M = lambda x: x
	x = _map(torch.zeros_like, b) if x0 is None else x0
	r = _map(lambda bi, ai: bi - ai, b, A(x))
	z = M(r)
	rz0 = rz = dot(r, z)
	p = z
	it, err = 0, None
	while it < maxiter and (err is None or float(err) > tol*tol):
		Ap = A(p)
		alpha = rz/dot(p, Ap)
		x = _map(lambda xi, pi: xi + alpha*pi, x, p)
		r = _map(lambda ri, api: ri - alpha*api, r, Ap)
		z = M(r)
		rz2 = dot(r, z)
		beta = rz2/rz
		p = _map(lambda zi, pi: zi + beta*pi, z, p)
		rz = rz2
		it += 1
		err = rz2/rz0
	if err is None: err = torch.full_like(torch.as_tensor(rz0), float("inf"))
	return x, dict(iters=it, err=torch.sqrt(torch.abs(err)))


def jacobi_refine(forward, approx_inverse, b, niter=3):
	"""x_{k+1} = x_k + Ainv(b - A x_k) from x_0 = Ainv(b), niter times: the
	iterative quadrature refinement of map2alm (pixell_tpu.ops.solvers.
	jacobi_refine)."""
	x = approx_inverse(b)
	for _ in range(niter):
		r = _map(lambda bi, fi: bi - fi, b, forward(x))
		x = _map(lambda xi, di: xi + di, x, approx_inverse(r))
	return x
