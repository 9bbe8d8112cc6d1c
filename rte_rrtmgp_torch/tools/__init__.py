"""Tools of the port: measurement tools that run on a card, the tracer
benchmarks (``bench_rt``, ``bench_bw``), the NumPy input preprocessing of
``cli_rt --tica`` and the camera tools (``set_virtual_camera``,
``image_from_xyz``, ``box_cloud``)
(``python3 -m rte_rrtmgp_torch.tools.<name>``)."""
