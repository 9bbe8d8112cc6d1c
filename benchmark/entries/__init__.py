"""Entry drivers, one a file, found by the name a traffic mix gives.

Each ``<entry>.py`` defines ``RUNS`` (what the path it drives computes:
``clouds``, ``aerosols``, ``n_gauss_angles``; a configuration that states
otherwise is refused) and ``Entry(cell, device)``: built at set-up from
the benchmark's inputs (``cell.raws``, ``cell.atm``, ``cell.gases``, in
``cell.dtype``), with ``call()`` (one call of the program ending in a
synchronize with the card; returns the outputs the reference judges, name
-> array or tensor), ``reference_inputs()`` (the same inputs as NumPy,
with ``gases``, the order of ``vmr``'s last axis, for the reference) and
``close()`` (drops the program's state).
"""
