"""Communicators over torch.distributed (counterpart of
pixell_tpu/parallel/dist.py).

The reference wraps jax.distributed in JaxCommunicator with the
single-process FakeCommunicator as its fallback (pixell's mpi.py:13-25,
mpiutils.py:6-24). Here TorchCommunicator runs the same host-level
operations (numpy in, numpy out) over torch.distributed's default group,
on the CPU for gloo and through the card for NCCL. The transforms' own
collectives run inside parallel.sht_dist on device tensors.

Everything is ported, JaxCommunicator as TorchCommunicator.
COMM_WORLD differs from the reference's in one respect: the reference
evaluates world() at import (dist.py:77), but a torch process group is
usually initialized after the import, so COMM_WORLD looks the default
group up each time it is used.
"""
from __future__ import annotations
import os
import sys
import numpy as np
import torch
import torch.distributed as tdist


class FakeCommunicator:
	"""Single-process communicator: every operation is the identity
	(pixell_tpu.parallel.dist.FakeCommunicator :17)."""
	rank = 0
	size = 1
	def allreduce(self, a, op=None): return a
	def reduce(self, a, op=None, root=0): return a
	def allgather(self, a): return np.asarray(a)[None]
	def allgatherv(self, a, axis=0): return np.asarray(a)
	def alltoallv(self, a, counts=None): return np.asarray(a)
	def bcast(self, a, root=0): return a
	def barrier(self): pass
	def Abort(self, code=1):
		sys.exit(code)
	def Barrier(self): pass
	def Get_rank(self): return 0
	def Get_size(self): return 1


_OPS = {None: "SUM", "sum": "SUM", "max": "MAX", "min": "MIN"}


class TorchCommunicator:
	"""Cross-process communicator over torch.distributed's default group
	(the counterpart of pixell_tpu.parallel.dist.JaxCommunicator :35), for
	host data: numpy arrays in and out. Needs an initialized process group;
	its tensors go through the CPU on gloo and the card on NCCL."""
	@property
	def rank(self): return tdist.get_rank()
	@property
	def size(self): return tdist.get_world_size()
	def _device(self):
		if tdist.get_backend() != "nccl": return torch.device("cpu")
		return torch.device("cuda", torch.cuda.current_device())
	def _tensor(self, a):
		"""A copy of a on the group's device (the collectives work in place)."""
		a = np.array(a, dtype=np.asarray(a).dtype.newbyteorder("="), copy=True, order="C")
		return torch.from_numpy(a).to(self._device())
	def allreduce(self, a, op=None):
		if op not in _OPS: raise ValueError(op)
		x = self._tensor(a)
		tdist.all_reduce(x, op=getattr(tdist.ReduceOp, _OPS[op]))
		res = x.cpu().numpy()
		return res if isinstance(a, np.ndarray) else res[()]
	def reduce(self, a, op=None, root=0):
		return self.allreduce(a, op)
	def Reduce(self, sendbuf, recvbuf, op=None, root=0):
		"""mpi4py's Reduce: the reduction (op None or "sum", "max", "min") of
		every rank's sendbuf written into recvbuf on root; recvbuf is not
		read, and not touched on the other ranks."""
		if op not in _OPS: raise ValueError(op)
		x = self._tensor(sendbuf)
		tdist.reduce(x, dst=root, op=getattr(tdist.ReduceOp, _OPS[op]))
		if self.rank == root: recvbuf[...] = x.cpu().numpy()
	def allgather(self, a):
		x = self._tensor(a)
		out = [torch.empty_like(x) for _ in range(self.size)]
		tdist.all_gather(out, x)
		return np.stack([o.cpu().numpy() for o in out])
	def allgatherv(self, a, axis=0):
		parts = [None]*self.size
		tdist.all_gather_object(parts, np.asarray(a))
		return np.concatenate(parts, axis=axis)
	def bcast(self, a, root=0):
		obj = [a]
		tdist.broadcast_object_list(obj, src=root)
		return obj[0]
	def send(self, obj, dest=0, tag=0):
		tdist.send_object_list([obj], dst=dest)
	def recv(self, source=0, tag=0):
		obj = [None]
		tdist.recv_object_list(obj, src=source)
		return obj[0]
	def Send(self, buf, dest=0, tag=0):
		tdist.send(self._tensor(buf), dst=dest)
	def Recv(self, buf, source=0, tag=0):
		x = self._tensor(buf)
		tdist.recv(x, src=source)
		buf[...] = x.cpu().numpy()
	def Alltoallv(self, send, recv):
		"""mpi4py's Alltoallv((sendbuf, (sendn, sendoff)), (recvbuf, (recvn,
		recvoff))) on all_to_all_single: segment i of sendbuf goes to rank i,
		the one from rank i lands at recvoff[i] of recvbuf."""
		(sbuf, (sn, so)), (rbuf, (rn, ro)) = send, recv
		sbuf = np.asarray(sbuf).reshape(-1)
		packed = np.concatenate([sbuf[int(o):int(o) + int(n)] for n, o in zip(sn, so)])
		out = torch.empty(int(np.sum(rn)), dtype=torch.from_numpy(packed[:0]).dtype, device=self._device())
		tdist.all_to_all_single(out, self._tensor(packed), [int(n) for n in rn], [int(n) for n in sn])
		got, i = out.cpu().numpy(), 0
		flat = rbuf.reshape(-1)
		for n, o in zip(rn, ro):
			flat[int(o):int(o) + int(n)] = got[i:i + int(n)]
			i += int(n)
	def barrier(self):
		tdist.barrier()
	Barrier = barrier
	def Abort(self, code=1):
		os._exit(code)
	def Get_rank(self): return self.rank
	def Get_size(self): return self.size


def world():
	"""The best communicator available: TorchCommunicator over the default
	group when one is initialized with more than one rank, else the
	single-process fallback (pixell_tpu.parallel.dist.world :66)."""
	if tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1:
		return TorchCommunicator()
	return FakeCommunicator()


class _World:
	"""COMM_WORLD: world() at the time of each use. The reference evaluates
	world() once at import; a torch process group is usually initialized
	after the import, so this looks the default group up every time."""
	def __getattr__(self, name):
		return getattr(world(), name)
	def __repr__(self):
		return "COMM_WORLD(%r)" % world()


COMM_WORLD = _World()
COMM_SELF = FakeCommunicator()


def allreduce(a, comm=None, op=None):
	comm = comm or COMM_WORLD
	return comm.allreduce(a, op=op)

def allgather(a, comm=None):
	comm = comm or COMM_WORLD
	return comm.allgather(a)

def allgatherv(a, comm=None, axis=0):
	comm = comm or COMM_WORLD
	return comm.allgatherv(a, axis=axis)

def install_abort_hook(comm=None):
	"""Turn uncaught exceptions into a hard abort so distributed jobs don't
	hang (pixell_tpu.parallel.dist.install_abort_hook :93)."""
	comm = comm or COMM_WORLD
	old_hook = sys.excepthook
	def hook(type, value, tb):
		old_hook(type, value, tb)
		getattr(comm, "Abort", lambda c: sys.exit(c))(1)
	sys.excepthook = hook
