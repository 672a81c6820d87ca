"""One torch intra-op thread per test process, for the port's tests.

The suite runs on several xdist workers at once. Left alone, every
worker's torch starts a pool of one thread per core for its intra-op
work, and those pools, beside XLA's, oversubscribe the cores: the port's
many small CPU ops then spend their time waiting on each other.
Every ``tests/test_torch_*.py`` imports this module first. The parity
bars do not move: the port's sums whose order matters (forest-order
accumulation, integer histograms, split scans) do not depend on the
thread count, and every exact test still holds with one thread.
"""
import torch

torch.set_num_threads(1)
