"""Hand-written CUDA kernels (sources in ``rte_rrtmgp_torch/csrc``) and
their wrappers.

Every wrapper dispatches by tensor device and dtype: a CPU tensor or a
float64 tensor runs the kernel's plain PyTorch twin (the JAX package runs
its Pallas kernels for float32 only), a CUDA float32 tensor launches the
kernel (built at first use), anything else raises.  Each launch adds one
to the wrapper's count in :data:`LAUNCHES`, and a gas-optics launch its
chunk's minor intervals to :data:`MINOR_SCALED` (:func:`minor_scaled`); a
twin counts nothing.  :data:`CLRSKY_GPTS` (:func:`clrsky_gpts`) counts the
g-points a clear-sky call solved on its gas-only optics, kernels or twins;
:data:`SW_FUSED_GPTS` (:func:`sw_fused_gpts`) the g-points whose SW optics
a launch of the SW kernel's fused entries formed itself.
"""

from ._build import (CLRSKY_GPTS, LAUNCHES, MINOR_SCALED, SW_FUSED_GPTS,
                     build, clrsky_gpts, launch_counts, minor_scaled,
                     reset_launch_counts, sw_fused_gpts)

__all__ = ["CLRSKY_GPTS", "LAUNCHES", "MINOR_SCALED", "SW_FUSED_GPTS",
           "build", "clrsky_gpts", "launch_counts", "minor_scaled",
           "reset_launch_counts", "sw_fused_gpts"]
