"""Hand-written CUDA kernels (sources in ``rte_rrtmgp_torch/csrc``) and
their wrappers.

Every wrapper dispatches by tensor device and dtype: a CPU tensor or a
float64 tensor runs the kernel's plain PyTorch twin (the JAX package runs
its Pallas kernels for float32 only), a CUDA float32 tensor launches the
kernel (built at first use), anything else raises.  Each launch adds one
to the wrapper's count in :data:`LAUNCHES`; a twin counts nothing.
"""

from ._build import LAUNCHES, build, launch_counts, reset_launch_counts

__all__ = ["LAUNCHES", "build", "launch_counts", "reset_launch_counts"]
