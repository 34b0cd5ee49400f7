"""Process settings for the port's CPU tests, imported by every
``tests/test_torch_*.py`` module.

The suite runs in several pytest-xdist workers on one host, the JAX
package's tests beside the port's. torch's CPU ops would each start one
intra-op thread a core in every worker, and the port's tests run at small
shapes that gain nothing from them; the surplus threads only take cores
from the other workers, whose timing-bound tests (rate-controller ticks,
overload ladders) then run late. One intra-op thread a process keeps the
port's tests to the core they run on.
"""

import torch

torch.set_num_threads(1)
