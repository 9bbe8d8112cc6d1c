"""Hand-written CUDA kernels (sources in ``rte_rrtmgp_torch/csrc``) and
their wrappers.

Every wrapper dispatches by tensor device and dtype: a CPU tensor or a
float64 tensor runs the kernel's plain PyTorch twin (the JAX package runs
its Pallas kernels for float32 only), a CUDA float32 tensor launches the
kernel (built at first use), anything else raises.  Each launch adds one
to the wrapper's count in :data:`LAUNCHES`, and what it did besides to
:data:`WORK`: a gas-optics launch its chunk's minor intervals
(:func:`minor_scaled`), a launch of the SW kernel's fused entries the
g-points whose SW optics it formed itself (:func:`sw_fused_gpts`); a twin
counts nothing.
"""

from ._build import (LAUNCHES, WORK, build, launch_counts, minor_scaled,
                     reset_launch_counts, sw_fused_gpts)

__all__ = ["LAUNCHES", "WORK", "build", "launch_counts", "minor_scaled",
           "reset_launch_counts", "sw_fused_gpts"]
