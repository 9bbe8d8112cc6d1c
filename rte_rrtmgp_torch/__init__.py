"""rte_rrtmgp_torch — the RTE+RRTMGP radiation framework in PyTorch and CUDA.

The port of ``rte_rrtmgp_tpu`` (JAX/Pallas), module for module under the same
names: RRTMGP gas, cloud and aerosol optics, the RTE longwave no-scattering
and shortwave two-stream solvers, and the flagship all-sky step
(:mod:`rte_rrtmgp_torch.step`).  Plain tensor code is PyTorch; the hot
kernels are hand-written CUDA for Hopper (``csrc/``, wrappers in
``ops/kernels``), built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no CPU request they raise.  A CPU tensor takes each kernel's
plain PyTorch twin.
"""

from . import config

__version__ = "0.1.0"
