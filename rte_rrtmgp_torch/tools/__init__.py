"""Measurement tools of the port that run on a card (``python3 -m
rte_rrtmgp_torch.tools.<name>``)."""
