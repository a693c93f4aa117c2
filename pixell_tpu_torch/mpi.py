"""MPI compatibility shim (counterpart of pixell_tpu/mpi.py).

The communication layer is pixell_tpu_torch.parallel (torch.distributed).
This module keeps the reference's import surface: COMM_WORLD, COMM_SELF,
FakeCommunicator, TorchCommunicator (JaxCommunicator's counterpart) and
itemhack. disabled is looked up at each use, as COMM_WORLD is (the process
group is usually initialized after the import).
"""
from .parallel.dist import (FakeCommunicator, TorchCommunicator, world,
	COMM_WORLD, COMM_SELF, install_abort_hook)
import numpy as _np


def __getattr__(name):
	if name == "disabled": return COMM_WORLD.size == 1
	raise AttributeError("module %r has no attribute %r" % (__name__, name))


class itemhack:
	"""The reference's >2^31-element Alltoallv workaround (pixell_tpu.mpi.
	itemhack :17). all_to_all_single counts elements in 64 bits, so it is a
	plain Alltoallv here; in the single-process case an offset-respecting
	copy."""
	@staticmethod
	def Alltoallv(sendbuf, sendn, sendoff, recvbuf, recvn, recvoff, comm, bsize=1):
		sendn, sendoff = _np.asarray(sendn), _np.asarray(sendoff)
		recvn, recvoff = _np.asarray(recvn), _np.asarray(recvoff)
		if getattr(comm, "size", 1) == 1:
			for i in range(len(sendn)):
				n = int(sendn[i])
				recvbuf[int(recvoff[i]):int(recvoff[i]) + n] = \
					sendbuf[int(sendoff[i]):int(sendoff[i]) + n]
			return
		comm.Alltoallv((sendbuf, (sendn, sendoff)), (recvbuf, (recvn, recvoff)))
