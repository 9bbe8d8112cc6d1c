"""The repo's Python-API walkthroughs in PyTorch, the ports of
``examples/basic_usage.py``, ``examples/multichip_sharding.py`` and
``examples/raytrace_3d.py``
(``python -m rte_rrtmgp_torch.examples.<name> [--device cpu]``).  Each runs
on ``cuda`` unless the caller passes ``--device cpu``."""

from __future__ import annotations

import argparse

import torch

from .. import config


def device_from_args(description: str) -> torch.device:
    """The walkthrough's device from ``--device`` (default ``cuda``; raises
    where there is no card, as every entry point of the port does)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return config.resolve_device(p.parse_args().device)
