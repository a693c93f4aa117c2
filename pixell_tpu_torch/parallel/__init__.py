"""Multi-device distribution: meshes, communicators, sharded transforms
(counterpart of pixell_tpu/parallel/).

The reference's jax.sharding meshes become torch.distributed: a mesh is a
DeviceMesh, a sharded array a DTensor, a shard_map body explicit local work
on each rank's share, a psum an all-reduce and a resharding a DTensor
redistribute (an all-to-all). Everything of the reference is ported;
JaxCommunicator's counterpart is TorchCommunicator.
"""
from . import mesh, dist, sht_dist
from .mesh import get_mesh, local_mesh
from .dist import FakeCommunicator, COMM_WORLD, COMM_SELF, allreduce, allgather
