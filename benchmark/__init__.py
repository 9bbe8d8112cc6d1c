"""The benchmark of the PyTorch/CUDA port ``rte_rrtmgp_torch`` (see
``run.py``)."""
