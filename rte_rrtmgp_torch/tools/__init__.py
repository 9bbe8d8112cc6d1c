"""Tools of the port: measurement tools that run on a card, the tracer
benchmarks (``bench_rt``, ``bench_bw``, ``bench_rt_solve``), the tools
around the main path that the repository's root ``tools/`` holds for the
JAX package (``crosscheck``, ``profile_stages``, ``ablate``,
``scaling_bench``, ``plot_fluxes``), the frozen tracer goldens
(``make_goldens``), the NumPy input preprocessing of ``cli_rt --tica`` and
the camera tools (``set_virtual_camera``, ``image_from_xyz``,
``box_cloud``) (``python3 -m rte_rrtmgp_torch.tools.<name>``)."""
