"""Two processes of the port's multi-process tool
(``python -m rte_rrtmgp_torch.tools.multihost_smoke``) on the CPU, in both
layouts: the default one (``--gpt-shards 1``: each process a column slab,
the means all-reduced over the cols group) and the ``gpt`` axis across the
two processes (``--gpt-shards 2``: each computes half the spectrum of the
group's 64 columns, gathered from both; the partial fluxes are
all-reduced).

The processes of a layout join one gloo group over localhost (the two
layouts run at once, on two ports), each loads its own slab of 32 columns
of the same seeded 64-column atmosphere (24 layers, 2 g-points a band,
float64), and each prints the global means of ``lw_flux_up`` and
``sw_flux_dn`` and the column-order check (the mean of their sum, column i
weighted by i + 1).  Each line must agree with the other process's and
with the same numbers from JAX's unsharded step on the same 64 columns, run
in this process while the children work, at rtol 1e-10.  The children
import torch, numpy and the port only (``test_torch_imports.py`` holds the
tool to that), and run two threads each (``OMP_NUM_THREADS``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import __graft_entry__ as ge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL_PER_PROCESS, NLAY, GPB = 32, 24, 2
LAYOUTS = (1, 2)   # --gpt-shards


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_values():
    """RESULT's three numbers from JAX's unsharded step on all columns."""
    ncol = 2 * NCOL_PER_PROCESS
    arrs = ge._atmos_arrays(ncol=ncol, nlay=NLAY, dtype=np.float64)
    names = ("p_lay", "p_lev", "t_lay", "t_lev", "t_sfc", "vmr",
             "col_dry", "emis_sfc", "sfc_alb_dir", "sfc_alb_dif",
             "tsi_scaling", "mu0", "lwp", "iwp", "rel", "dei")
    out = jax.jit(ge.make_step(*ge._build(GPB, dtype=np.float64)))(
        *[arrs[k] for k in names])
    lw, sw = np.asarray(out["lw_flux_up"]), np.asarray(out["sw_flux_dn"])
    w = np.arange(1, ncol + 1, dtype=np.float64)[:, None]
    return (lw.mean(), sw.mean(),
            (w * (lw + sw)).sum() / (lw.size * (ncol + 1) / 2))


@pytest.fixture(scope="module")
def runs():
    """{gpt_shards: (JAX's values, [(returncode, stdout, stderr)] of the
    two processes)}; both layouts run at once, JAX while they do."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("LOCAL_RANK", None)
    procs = {}
    for k in LAYOUTS:
        port = _free_port()
        procs[k] = [
            subprocess.Popen(
                [sys.executable, "-m",
                 "rte_rrtmgp_torch.tools.multihost_smoke",
                 "--device", "cpu", "--precision", "float64",
                 "--gpt-shards", str(k),
                 "--ncol-per-process", str(NCOL_PER_PROCESS),
                 "--nlay", str(NLAY), "--gpt-per-band", str(GPB),
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 "2", "--process-id", str(i)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for i in range(2)]
    try:
        ref = _jax_values()
        done = {k: [(p.communicate(timeout=120), p.returncode)[::-1]
                    for p in ps] for k, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
    return {k: (ref, v) for k, v in done.items()}


def _check(ref, outs):
    results = {}
    for rc, (so, se) in outs:
        assert rc == 0, se[-3000:]
        assert "backend gloo, device cpu" in so, so
        line = next(ln for ln in so.splitlines() if ln.startswith("RESULT"))
        _, pid, *values = line.split()
        results[int(pid)] = [float(v) for v in values]
    assert set(results) == {0, 1}
    np.testing.assert_allclose(results[0], results[1], rtol=1e-10)
    np.testing.assert_allclose(results[0], ref, rtol=1e-10)


def test_two_gloo_processes_cols_across_them_match_jax(runs):
    _check(*runs[1])


def test_two_gloo_processes_gpt_across_them_match_jax(runs):
    _check(*runs[2])
