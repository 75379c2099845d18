"""K5's class table (``kernels.edge_map.ops.build_class_table``) and the
fused edge map's CPU path, on the CPU.

The table: one row per class that holds rows, in the tiles' order, with
the class's planes, shapes and lane group (``lanes_per_row``), each wide
class with its segment list; the table is built once per tile set, not per
call.  How the grouped entry batches the classes, groups them into
launches and cuts them into blocks is the kernel library's own, checked on
the card (``test_torch_cuda``).  The CPU path of ``fused_edge_map`` still
equals the per-class map of the plain version on every case the card's
parity test runs, an empty base set included, and engages no grouped
launch.

Imports only torch and the port.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import edge_map_cases as cases  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.graph import datasets  # noqa: E402
from repro_torch.kernels._wrap import lanes_per_row  # noqa: E402
from repro_torch.kernels.edge_map import (TileSet,  # noqa: E402
                                          ell_edge_map, fused_edge_map, ops,
                                          refresh_alive)
from repro_torch.obs import metrics  # noqa: E402

F = {name: i for i, name in enumerate(ops.CLASS_FIELDS)}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset_registry()
    yield
    metrics.reset_registry()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these maps are small, and beside the other
    test workers a pool of threads per op only waits on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SETS = [f"{kind}-{ids}-w{w}-a{a}" for kind in ("hub", "single")
        for ids in ("uint16", "int32") for w in (0, 1) for a in (0, 1)]
SETS += ["kr", "kr-packed"]


@functools.lru_cache(maxsize=None)
def _tiles(name):
    """A tile set of the parity cases (``<kind>-<ids>-w<weighted>-a<alive>``)
    or the ``kr`` test graph's ``ell`` / ``packed`` tiles, on the CPU."""
    if name.startswith("kr"):
        backend = "packed" if name.endswith("packed") else "ell"
        g = datasets.load_weighted("kr", "test")
        return apps.to_arrays(g, backend=backend, device=CPU).in_tiles
    kind, ids, w, a = name.split("-")
    sets, _ = cases.tile_sets(kind, ids, CPU)
    return sets[w == "w1", a == "a1"][0]


@pytest.mark.parametrize("name", SETS)
def test_the_table_holds_each_class_once_in_the_tiles_order(name):
    tiles = _tiles(name)
    assert isinstance(tiles, TileSet)
    table = tiles.table
    live = [t for t in tiles if t.num_rows]
    assert table.classes == len(live) > 0
    assert table.host.shape == (len(live), len(ops.CLASS_FIELDS))
    assert table.host.dtype == np.int64 and table.device == CPU
    assert [int(p) for p in table.host[:, F["idx"]]] == [
        t.idx.data_ptr() for t in live]
    # a class with no rows takes no row of the table
    with_empty = TileSet(tuple(tiles) + (live[-1]._replace(
        rows=live[-1].rows[:0]),))
    np.testing.assert_array_equal(with_empty.table.host, table.host)


@pytest.mark.parametrize("name", SETS)
def test_each_row_holds_its_class_planes_and_lane_group(name):
    tiles = _tiles(name)
    table = tiles.table
    partial = 0
    for row, t in zip(table.host, [t for t in tiles if t.num_rows]):
        r_pad, width = t.idx.shape
        group = lanes_per_row(width)
        assert row[F["group"]] == group and row[F["width"]] == width
        assert row[F["plane_rows"]] == r_pad
        assert row[F["num_rows"]] == t.num_rows
        assert row[F["idx_bytes"]] == t.idx.element_size()
        assert row[F["rows"]] == t.rows.data_ptr()
        assert row[F["deg"]] == t.deg.data_ptr()
        for f in ("w", "alive"):
            plane = getattr(t, f)
            assert row[F[f]] == (0 if plane is None else plane.data_ptr())
        if group == 256:
            assert row[F["segs"]] == t.segments.data_ptr()
            assert row[F["num_segs"]] == t.segments.shape[0] > 0
            partial += int(t.segments.shape[0])
        else:
            assert row[F["segs"]] == 0 and row[F["num_segs"]] == 0
    assert table.partial_rows == partial
    assert table.keep == ()  # every wide class brought its own list


def test_the_table_is_built_once_per_tile_set(monkeypatch):
    built = []
    real = ops.build_class_table

    def counting(tiles):
        built.append(len(tiles))
        return real(tiles)

    monkeypatch.setattr(ops, "build_class_table", counting)
    g = datasets.load_weighted("kr", "test")
    x = torch.rand(g.num_vertices)
    for backend in ("ell", "packed"):
        ga = apps.to_arrays(g, backend=backend, device=CPU)
        assert isinstance(ga.in_tiles, TileSet)
        table = ga.in_tiles.table
        n = len(built)
        for _ in range(3):
            ga.pull(x)
            ga.push(x, init=torch.zeros_like(x))
            fused_edge_map(ga.in_tiles, x, g.num_vertices)
        assert len(built) == n and ga.in_tiles.table is table
    # new alive planes are a new tile set, with a table of its own
    ga = apps.to_arrays(g, backend="ell", device=CPU)
    keep = np.ones(g.in_csr.indices.shape[0], bool)
    n = len(built)
    fresh = refresh_alive(g.in_csr, ga.in_tiles, keep)
    assert isinstance(fresh, TileSet) and len(built) == n + 1
    assert fresh.table is not ga.in_tiles.table


@pytest.mark.parametrize("case", cases.CASES, ids=cases.case_id)
def test_cpu_fused_edge_map_matches_the_per_class_plain_version(case):
    """The same cases as the card's parity test (``CPU_VARIANTS`` of each):
    on the CPU, ``fused_edge_map`` is the per-class plain version, bitwise,
    and counts no grouped call and no kernel launch."""
    mode, reduce, kind, ids = case
    sets, v = cases.tile_sets(kind, ids, CPU)
    launches = ell_edge_map.launches
    for i, (weights, frontier, alive, k) in enumerate(cases.CPU_VARIANTS):
        tiles, extra = sets[weights == "plane", alive]
        x, fr, init = cases.inputs(v, k, frontier, CPU, seed=i)
        kw = dict(cases.map_kw(reduce, weights), src_frontier=fr,
                  init=init if mode == "push" else None, extra_tiles=extra)
        want = cases.oracle(tiles, x, v, **kw)
        seed = None if mode == "pull" else init.clone()
        got = fused_edge_map(tiles, x, v, **kw)
        assert torch.equal(got, want), (weights, frontier, alive, k)
        if seed is not None:
            assert torch.equal(init, seed)  # init is left as it was
    assert ell_edge_map.launches == launches
    reg = metrics.get_registry()
    assert reg.get("edge_map.grouped.calls") is None
    assert reg.get("edge_map.grouped.classes") is None


@pytest.mark.parametrize("mode", ("pull", "push"))
@pytest.mark.parametrize("reduce", ("sum", "min", "max"))
def test_an_empty_base_set_maps_to_its_fill_and_the_extras(mode, reduce):
    """A tile set with no class (a graph with no edges) has an empty table
    on no device; mapped with extra tiles, every vertex takes the fill (or
    ``init``) and then the extras, as the per-class plain version gives."""
    _, extra = cases.tile_sets("extra", "uint16", CPU)[0][True, False]
    v = cases.edges("hub", "uint16")[3]
    base = cases.empty_base(v, CPU)
    assert isinstance(base, TileSet) and len(base) == 0
    assert base.table.classes == 0 and base.table.device is None
    assert base.table.partial_rows == 0
    x, fr, init = cases.inputs(v, 1, "shared", CPU, seed=5)
    kw = dict(cases.map_kw(reduce, "plane"), src_frontier=fr,
              init=init if mode == "push" else None, extra_tiles=extra)
    got = fused_edge_map(base, x, v, **kw)
    assert torch.equal(got, cases.oracle(base, x, v, **kw))
    rows = extra[0].rows
    untouched = torch.ones(v, dtype=torch.bool)
    untouched[rows] = False
    fill = (init if mode == "push"
            else torch.full((v,), cases.IDENTITY[reduce]))
    assert torch.equal(got[untouched], fill[untouched])
