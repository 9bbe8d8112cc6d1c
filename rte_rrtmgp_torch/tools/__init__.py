"""Tools of the port: measurement tools that run on a card, the tracer
benchmark and the NumPy input preprocessing of ``cli_rt --tica``
(``python3 -m rte_rrtmgp_torch.tools.<name>``)."""
