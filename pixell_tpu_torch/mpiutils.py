"""Alias of the communicator fallback module (counterpart of
pixell_tpu/mpiutils.py); all of it is ported."""
from .parallel.dist import FakeCommunicator, COMM_WORLD, COMM_SELF
FAKE_WORLD = FakeCommunicator()
