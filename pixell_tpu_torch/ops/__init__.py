"""Legendre stage of the SHT: the plain PyTorch scan (sht_core) and the
hand-written CUDA kernels with their dispatch (sht_cuda)."""
