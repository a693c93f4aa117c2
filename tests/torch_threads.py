"""One torch intra-op thread in each pytest-xdist worker.

The port's tests run the kernels' plain twins on the CPU in torch. With
several xdist workers, each running torch on every core, the workers'
threads wait for each other and a test can take ten times as long as it
does alone. Every tests/test_torch_*.py imports this module, so the cap
holds in whichever worker collects it first; a run without xdist keeps
torch's default. A file that sets its own count for a while
(test_torch_blocked.py) takes it from here and restores it.
"""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
	torch.set_num_threads(1)
