"""Hand-written CUDA kernels (sources in ``rte_rrtmgp_torch/csrc``) and
their wrappers.

Every wrapper dispatches by tensor device: a CPU tensor runs the kernel's
plain PyTorch twin, a CUDA float32 tensor launches the kernel (built at
first use), anything else raises.  Each launch adds one to the wrapper's
count in :data:`LAUNCHES`.
"""

from ._build import LAUNCHES, build, launch_counts, reset_launch_counts

__all__ = ["LAUNCHES", "build", "launch_counts", "reset_launch_counts"]
