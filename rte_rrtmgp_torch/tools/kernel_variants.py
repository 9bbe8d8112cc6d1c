"""Time the design variants of three kernels on the card, at the inputs of
one flagship step (2048 columns x 72 layers, 256 LW + 224 SW g-points,
gpt_chunk 128 unless ``--gpt-chunk`` says otherwise, float32):

* the LW sweep (B2 ``lw_sweep``, B6 ``lw_sweep_lm``): g-points a block (a
  column's cluster of blocks); in a checkout whose LW kernel has no such
  choice (copied into a parent's), the kernel as built;
* the SW two-stream solve (B3 and B7, through the fused entries
  ``sw_2stream_fused`` / ``sw_2stream_fused_lm`` that the step calls):
  g-tile width x threads a block;
* the gas-optics interpolation (B1 ``gas_optics_interp``): cells a block x
  threads a block, in the default and the layer-major layout.

Run from the repository root on a machine with one NVIDIA card:

    python3 -m rte_rrtmgp_torch.tools.kernel_variants [--kernels lw,sw,b1]
        [--gpt-chunk N]

Each variant is held to the plain twin first (LW and SW within 1e-5 of the
output's largest value; B1 bit for bit), then its launches of one step are
timed with CUDA events (mean of 20 after 3 warm-up launches, summed over
the step's launches).  The last line is one JSON object with every
variant's ms per step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

NCOL, NLAY = 2048, 72
GPT_PER_BAND, GPT_CHUNK = 16, 128
LW_BLOCK_GS = (32, 64, 128, 256)
REL_TOL = 1e-5


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def patched(*triples):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, value in triples:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def record_step(run_step, args, targets):
    """The calls of one step to each (module, name) in ``targets``."""
    import torch

    calls = {name: [] for _, name in targets}

    def recorder(name, fn):
        def rec(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return rec
    with patched(*[(mod, name, recorder(name, getattr(mod, name)))
                   for mod, name in targets]):
        run_step(*args)
    torch.cuda.synchronize()
    return calls


def time_variant(key, fn, recs, refs, results):
    """Hold ``fn`` to the twin's outputs on every recorded launch, then time
    the launches; records the ms per step under ``key``.  False on a
    disagreement."""
    err, ms = 0.0, []
    for (a, kw), ref in zip(recs, refs):
        got = fn(*a, **kw)
        for x, r in zip(got, ref):
            e = float((x - r).abs().max())
            if e > REL_TOL * float(r.abs().max()):
                print(f"kernel_variants: FAIL {key}: max abs err {e:.3e}",
                      file=sys.stderr)
                return False
            err = max(err, e)
        ms.append(cuda_ms(lambda: fn(*a, **kw)))
    results[key] = sum(ms)
    print(f"[variant] {key}: ms/step {sum(ms):.4f} (per launch "
          f"{', '.join(f'{x:.4f}' for x in ms)}), max abs err {err:.3e}")
    return True


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="lw,sw,b1",
                    help="comma-separated subset of lw, sw, b1")
    ap.add_argument("--gpt-chunk", type=int, default=GPT_CHUNK,
                    help="g-points a spectral chunk (256: one LW chunk)")
    opts = ap.parse_args(argv)
    which = set(opts.kernels.split(","))
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from rte_rrtmgp_torch import step
    from rte_rrtmgp_torch.ops import gas_optics as go
    from rte_rrtmgp_torch.ops import rte_lw, rte_sw
    from rte_rrtmgp_torch.ops.kernels import _build
    from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as k_interp
    from rte_rrtmgp_torch.ops.kernels import solvers as k_solvers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    dev = torch.device("cuda")
    _build.library()

    tables = step.build_tables(GPT_PER_BAND, dtype=torch.float32, device=dev)
    arrs = step.atmos_arrays(NCOL, NLAY, seed=0)
    args = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
    targets = [(k_interp, "gas_optics_interp"),
               (k_solvers, "sw_2stream_fused"),
               (k_solvers, "sw_2stream_fused_lm"), (k_solvers, "lw_sweep"),
               (k_solvers, "lw_sweep_lm")]
    calls = {}
    for layout, kw in (("default", {}), ("layer_major",
                                         dict(layer_major=True))):
        run_step = step.make_step(*tables, gpt_chunk=opts.gpt_chunk, **kw)
        calls[layout] = record_step(run_step, args, targets)
    results = {}

    # ---- LW sweep: g-points a block ----
    lw_recs = {"lw_sweep": calls["default"]["lw_sweep"],
               "lw_sweep_lm": calls["layer_major"]["lw_sweep_lm"]}
    twins = {"lw_sweep": lambda *a, D, w: rte_lw.lw_sweep_plain(*a, D, w),
             "lw_sweep_lm": lambda *a, ncol, D, w: rte_lw.lw_sweep_lm_plain(
                 *a, ncol, D, w)}
    refs = {name: [twins[name](*a, **kw) for a, kw in recs]
            for name, recs in lw_recs.items()} if "lw" in which else {}
    chosen = hasattr(k_solvers, "LW_BLOCK_G")
    for gb in LW_BLOCK_GS if chosen else (None,):
        for name in refs:
            with patched(*([(k_solvers, "LW_BLOCK_G", gb)] if chosen else [])):
                key = f"{name} gb={gb}" if chosen else f"{name} as built"
                if not time_variant(key, getattr(k_solvers, name),
                                    lw_recs[name], refs[name], results):
                    return 1
    del refs

    # ---- SW two-stream: tile x threads ----
    twins = {"sw_2stream_fused": rte_sw.sw_2stream_fused_plain,
             "sw_2stream_fused_lm": rte_sw.sw_2stream_fused_lm_plain}
    sw_recs = {"sw_2stream_fused": calls["default"]["sw_2stream_fused"],
               "sw_2stream_fused_lm":
                   calls["layer_major"]["sw_2stream_fused_lm"]}
    refs = {name: [twins[name](*a, **kw) for a, kw in recs]
            for name, recs in sw_recs.items()} if "sw" in which else {}
    for gt in k_solvers.SW_TILES:
        for threads in (64, 128, 256, 512, 1024):
            if threads < gt:
                continue
            for name in refs:
                with patched((k_solvers, "SW_TILE", gt),
                             (k_solvers, "SW_THREADS", threads),
                             (k_solvers, "SW_THREADS_ALONE", threads)):
                    if not time_variant(f"{name} gt={gt} threads={threads}",
                                        getattr(k_solvers, name),
                                        sw_recs[name], refs[name], results):
                        return 1
    del refs

    # ---- B1: cells a block x threads, both layouts ----
    for layout in ("default", "layer_major") if "b1" in which else ():
        recs = calls[layout]["gas_optics_interp"]
        refs = [go.majmin_cells_plain(*a, **kw) for a, kw in recs]
        for tc in (8, 16, 32, 64, 128):
            for threads in (128, 256, 512):
                with patched((k_interp, "TILE_CELLS", tc),
                             (k_interp, "THREADS", threads)):
                    ms = []
                    for (a, kw), ref in zip(recs, refs):
                        got = k_interp.gas_optics_interp(*a, **kw)
                        if not all(torch.equal(x, r)
                                   for x, r in zip(got, ref)):
                            print(f"kernel_variants: FAIL gas_optics_interp "
                                  f"{layout} tc {tc} threads {threads}: not "
                                  "bit-equal to the twin", file=sys.stderr)
                            return 1
                        ms.append(cuda_ms(
                            lambda: k_interp.gas_optics_interp(*a, **kw)))
                key = f"gas_optics_interp {layout} tc={tc} threads={threads}"
                results[key] = sum(ms)
                print(f"[variant] {key}: ms/step {sum(ms):.4f} (per launch "
                      f"{', '.join(f'{x:.4f}' for x in ms)}), bit-equal")
        del refs
    print(f"[variants] card: {card}; gpt_chunk {opts.gpt_chunk}")
    print(json.dumps({"variants_ms_per_step": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
