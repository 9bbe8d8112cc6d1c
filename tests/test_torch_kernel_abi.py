"""The C interface of the port's CUDA kernels and the wrappers' launch
geometry, checked on the CPU (no nvcc, no card needed).

* Every ``extern "C"`` entry of ``rte_rrtmgp_torch/csrc/*.cu`` has the
  argument count and kinds (pointer / int / long long / float) that
  ``_build.SIGNATURES`` declares to ctypes: a mismatch would pass wrong
  values on the card without any error.
* The pure-Python geometry helpers (tile widths, g-points a block,
  shared-memory bytes, the LW and SW device-scratch branches) at the
  flagship (2048 x 72), golden (8 x 24) and edge shapes.
"""

import ctypes
import re

import pytest

from rte_rrtmgp_torch.ops.kernels import _build
from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as b1
from rte_rrtmgp_torch.ops.kernels import solvers

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _kind(arg: str):
    a = " ".join(arg.split())
    if "*" in a:
        return ctypes.c_void_p
    for prefix, kind in (("long long", ctypes.c_longlong),
                         ("int", ctypes.c_int), ("float", ctypes.c_float)):
        if a.startswith(prefix):
            return kind
    raise ValueError(f"unknown argument kind: {arg!r}")


def _entries():
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, args in ENTRY.findall(path.read_text()):
            args = [a for a in args.split(",") if a.strip() not in ("", "void")]
            out[name] = (path.name, tuple(_kind(a) for a in args))
    return out


ENTRIES = _entries()


def test_every_entry_is_declared():
    assert sorted(ENTRIES) == sorted(_build.SIGNATURES)
    assert {src for src, _ in ENTRIES.values()} == set(_build.SOURCES)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_signature(name):
    src, kinds = ENTRIES[name]
    declared = _build.SIGNATURES[name]
    assert len(kinds) == len(declared), (
        f"{src}:{name} takes {len(kinds)} arguments, SIGNATURES {len(declared)}")
    for i, (got, want) in enumerate(zip(kinds, declared)):
        assert got is want, f"{src}:{name} argument {i}: {got} vs {want}"


def test_sw_slots_match_the_source():
    text = (_build.CSRC / "sw_2stream.cu").read_text()
    m = re.search(r"constexpr int NSLOT = (\d+);", text)
    assert m and int(m.group(1)) == solvers.SW_SLOTS


def test_lw_staged_rows_match_the_source():
    text = (_build.CSRC / "lw_sweep.cu").read_text()
    m = re.search(r"constexpr int STAGED = (\d+);", text)
    assert m and int(m.group(1)) == solvers.LW_STAGED


def _lw_floats(nlay, gb):
    """A block's working set: a run of 2*nlay + 3 floats for each of its gb
    g-points, each warp's nlay+1 dn partials, in 16-byte units."""
    f = gb * (2 * nlay + 3) + -(-gb // 32) * (nlay + 1)
    return -(-f // 4) * 4


@pytest.mark.parametrize("ncol, nlay, G, gb, blocks, threads", [
    (2048, 72, 128, 128, 1, 128),   # flagship LW chunk
    (2048, 72, 96, 96, 1, 96),      # a 96-wide chunk
    (2048, 72, 256, 128, 2, 128),   # the whole LW k-distribution, one chunk
    (8, 24, 128, 128, 1, 128),      # golden case
    (17, 1, 1, 1, 1, 32),           # one layer, one g-point
    (17, 1, 13, 13, 1, 32),         # ragged g tail
    (5, 26, 1024, 128, 8, 128),     # widest chunk: a cluster of 8
    (5, 72, 300, 100, 3, 128),      # g-points shared out evenly
])
def test_lw_geometry_shared(ncol, nlay, G, gb, blocks, threads):
    geo = solvers.lw_geometry(ncol, nlay, G)
    assert (geo.gb, geo.blocks, geo.threads, geo.scratch_floats,
            geo.branch) == (gb, blocks, threads, 0, "shared")
    assert geo.smem_bytes == 4 * _lw_floats(nlay, gb)
    assert geo.smem_bytes <= _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("G", [128, 256, 1024])
def test_lw_flagship_fits_three_columns_an_sm(G):
    """Three 72-layer blocks of 128 g-points share an SM's 228 KB (each
    block also takes 1 KB of the SM's shared memory for itself), at every
    chunk width: a wider chunk is more blocks, not larger ones."""
    geo = solvers.lw_geometry(2048, 72, G)
    assert 3 * (geo.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("G, deepest_shared", [(1, 19369), (13, 2150),
                                                (96, 296), (128, 222),
                                                (1024, 222)])
def test_lw_scratch_branch_threshold(G, deepest_shared):
    """The device-scratch branch starts one layer past the deepest block
    whose working set fits in a block's shared memory."""
    assert solvers.lw_geometry(3, deepest_shared, G).branch == "shared"
    geo = solvers.lw_geometry(3, deepest_shared + 1, G)
    assert geo.branch == "global" and geo.smem_bytes == 0
    assert geo.scratch_floats == 3 * geo.blocks * _lw_floats(
        deepest_shared + 1, geo.gb)


@pytest.mark.parametrize("gb", [32, 64, 128, 256])
def test_lw_geometry_block_width(gb):
    """A requested block width stands where G needs at most a cluster of 8
    blocks of it; otherwise a wider G widens it to 8 blocks.  The g-points
    are shared out evenly: no block is empty and none exceeds the width."""
    geo = solvers.lw_geometry(2048, 72, 128, gb)
    assert (geo.gb, geo.blocks) == (min(gb, 128), -(-128 // gb))
    assert geo.threads == 32 * -(-geo.gb // 32)
    geo = solvers.lw_geometry(4, 8, 1024, gb)
    assert (geo.gb, geo.blocks) == (max(gb, 128), 1024 // max(gb, 128))
    geo = solvers.lw_geometry(4, 8, 200, gb)
    assert (geo.blocks - 1) * geo.gb < 200 <= geo.blocks * geo.gb
    assert geo.gb <= max(gb, 25) and geo.blocks <= solvers.MAX_CLUSTER
    for ncol, nlay, G in ((4, 72, 0), (4, 72, solvers.MAX_G + 1), (4, 0, 8)):
        with pytest.raises(ValueError):
            solvers.lw_geometry(ncol, nlay, G, gb)


def _sw_bytes(nlay, gt, tiles):
    return 4 * (5 * gt + 3 * tiles) * (nlay + 1)


@pytest.mark.parametrize("ncol, nlay, G, gt, tiles", [
    (2048, 72, 128, 32, 4),    # flagship LW/SW chunk
    (2048, 72, 96, 32, 3),     # last SW chunk
    (8, 24, 128, 32, 4),       # golden case
    (17, 1, 12, 32, 1),        # one layer
    (5, 355, 12, 32, 1),       # deepest in shared memory at G <= 32
    (5, 72, 300, 64, 5),       # the cluster limit widens the tile
    (5, 72, 1024, 128, 8),
])
def test_sw_geometry_shared(ncol, nlay, G, gt, tiles):
    geo = solvers.sw_geometry(ncol, nlay, G)
    assert (geo.gt, geo.tiles, geo.smem_bytes, geo.scratch_floats,
            geo.branch) == (gt, tiles, _sw_bytes(nlay, gt, tiles), 0,
                            "shared")
    assert geo.smem_bytes <= _build.SMEM_PER_BLOCK
    assert geo.threads >= geo.gt and geo.threads % 32 == 0


@pytest.mark.parametrize("G, deepest_shared", [(12, 355), (128, 336),
                                                (256, 314), (300, 172),
                                                (1024, 86)])
def test_sw_global_branch_threshold(G, deepest_shared):
    """The global-scratch branch starts one layer past the deepest column
    whose working set fits at the narrowest tile the cluster allows."""
    assert solvers.sw_geometry(3, deepest_shared, G).branch == "shared"
    geo = solvers.sw_geometry(3, deepest_shared + 1, G)
    assert geo.branch == "global" and geo.smem_bytes == 0
    assert geo.scratch_floats == 3 * geo.tiles * solvers.sw_block_floats(
        deepest_shared + 1, geo.gt, geo.tiles)


def test_sw_geometry_narrows_and_widens():
    # A preferred wide tile narrows until the working set fits.
    assert solvers.sw_geometry(4, 200, 128, gt=128).gt == 32
    assert solvers.sw_geometry(4, 72, 128, gt=128).gt == 128
    # Threads never fewer than the tile's g-points.
    assert solvers.sw_geometry(4, 72, 128, gt=128, threads=64).threads == 128
    for G in (0, solvers.MAX_G + 1):
        with pytest.raises(ValueError):
            solvers.sw_geometry(4, 72, G)


def _words(tc, G, F, nspec, nent):
    return (tc * (3 + 16 * F + nspec) + 2 * G + 3 * ((G + 3) // 4) + G + 1
            + 4 * nent)


@pytest.mark.parametrize("C, L, G, nspec, nent, axis, tc, blocks", [
    (2048, 72, 128, 8, 128, 0, 32, 64 * 72),   # flagship chunk with minors
    (2048, 72, 96, 0, 0, 0, 32, 64 * 72),      # flagship SW chunk, none
    (72, 2048, 128, 8, 128, 1, 32, 64 * 72),   # layer-major call
    (8, 24, 128, 8, 128, 1, 24, 8),            # golden case
    (37, 20, 13, 5, 50, 0, 32, 2 * 20),        # ragged tile and g tail
    (1, 1, 1, 0, 0, 0, 1, 1),
])
def test_interp_geometry(C, L, G, nspec, nent, axis, tc, blocks):
    F = 9
    geo = b1.interp_geometry(C, L, G, F, nspec, nent)
    assert (geo.axis, geo.tc, geo.blocks) == (axis, tc, blocks)
    assert geo.smem_bytes == 4 * _words(tc, G, F, nspec, nent)
    assert geo.threads == b1.THREADS


def test_interp_geometry_halves_the_tile_to_fit():
    # 4 words an entry: 12000 entries leave room for 32 cells, not 64.
    geo = b1.interp_geometry(2048, 72, 128, 9, 8, 12000, tc=64)
    assert geo.tc == 32 and geo.smem_bytes <= _build.SMEM_PER_BLOCK
    assert 4 * _words(64, 128, 9, 8, 12000) > _build.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        b1.interp_geometry(2048, 72, 128, 9, 8, 60000)


def test_minor_entries_order():
    """Entries by g, then interval (the twin's addition order); the count
    excludes the placeholder row of a chunk without minor intervals."""
    from rte_rrtmgp_torch.models.kdist import MinorSpec
    import torch
    spec = lambda g0, g1, k0, f: MinorSpec(
        **{**{fld: 0 for fld in MinorSpec._fields},
           "gpt_start": g0, "gpt_end": g1, "kminor_start": k0, "flavor": f})
    specs = ((0, spec(0, 2, 5, 3)), (1, spec(1, 3, 0, 4)))
    off, ent, nent, quad = b1._minor_entries(specs, 4, torch.device("cpu"))
    assert off.tolist() == [0, 1, 3, 4, 4] and nent == 4
    assert ent.tolist() == [[0, 0, 5, 3], [0, 0, 6, 3], [1, 1, 0, 4],
                            [1, 1, 1, 4]]
    assert quad.tolist() == [0]          # the four lists differ
    off, ent, nent, quad = b1._minor_entries((), 4, torch.device("cpu"))
    assert off.tolist() == [0] * 5 and nent == 0 and ent.shape == (1, 4)
    assert quad.tolist() == [0]          # no interval at all


def test_minor_entries_quads():
    """A quad reads its minor tables four at a time only where its four
    g-points share their intervals, with contributor columns c..c+3 from a
    multiple of 4."""
    from rte_rrtmgp_torch.models.kdist import MinorSpec
    import torch
    spec = lambda g0, g1, k0: MinorSpec(
        **{**{fld: 0 for fld in MinorSpec._fields},
           "gpt_start": g0, "gpt_end": g1, "kminor_start": k0, "flavor": 2})
    cpu = torch.device("cpu")
    # g 0-7 in one interval from column 16; g 8-11 from column 2; g 12-13
    # only half a quad.
    specs = ((0, spec(0, 8, 16)), (1, spec(0, 8, 40)), (0, spec(8, 12, 2)),
             (0, spec(12, 14, 0)))
    _, _, _, quad = b1._minor_entries(specs, 15, cpu)
    assert quad.tolist() == [1, 1, 0, 0]
