"""The port's AOT cache key covers every knob a program bakes in: twins of
``tests/test_engine.py::test_aot_cache_key_includes_every_baked_knob`` (its
eight flips, and the other engine knobs of the key's config) and
``tests/test_families.py::test_aot_key_covers_families_dim_and_seed``.
Flipping one knob must miss; the same knobs must hit every entry."""
import shutil

import numpy as np
import pytest

from repro.graphs.generators import power_law
from repro_torch.core import DBLIndex, make_graph
from repro_torch.serve.engine import QueryEngine
from tests.conftest import random_graph

CPU = "cpu"
BASE_KW = dict(bfs_chunk=32, max_iters=40)
FLIPS = (dict(frontier_dtype="int32"),
         dict(out_dtype="int32"),
         dict(plane_repr="packed"),
         dict(bfs_kernel=True),
         dict(max_iters=48),
         dict(halo_mode="sparse"),
         dict(hub_count=8),
         dict(halo_caps=(8, 32)),
         dict(streaming=True),
         dict(q_block=256),
         dict(bfs_chunk=16))
FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=7)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """An index and a cache dir filled by an engine with ``BASE_KW``."""
    src, dst = power_law(64, 160, seed=5)
    g = make_graph(src, dst, 64, m_cap=168, device=CPU)
    idx = DBLIndex.build(g, n_cap=64, k=8, k_prime=8, max_iters=40,
                         device=CPU)
    path = tmp_path_factory.mktemp("aot_base")
    e1 = QueryEngine(idx, **BASE_KW)
    e1.aot_warmup(idx, path)
    assert e1.aot_cache.stores > 0
    return idx, path, e1.aot_cache.stores


@pytest.mark.parametrize("flip", FLIPS,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_aot_cache_key_includes_every_baked_knob(base, flip, tmp_path):
    """A flipped knob misses every entry and stores its own; the unchanged
    knobs still hit every base entry beside them."""
    idx, path, stores = base
    cache = tmp_path / "cache"
    shutil.copytree(path, cache)
    e2 = QueryEngine(idx, **{**BASE_KW, **flip})
    e2.aot_warmup(idx, cache)
    assert e2.aot_cache.hits == 0, f"stale AOT hit under {flip}"
    assert e2.aot_cache.stores > 0, flip
    e3 = QueryEngine(idx, **BASE_KW)
    e3.aot_warmup(idx, cache)
    assert e3.aot_cache.stores == 0 and e3.aot_cache.hits == stores


def _graph(seed, *, n_max=24, m_max=80, m_extra=160):
    rng = np.random.default_rng(seed)
    n, src, dst = random_graph(rng, n_max=n_max, m_max=m_max)
    return n, src, dst, make_graph(src, dst, n, m_cap=len(src) + m_extra,
                                   device=CPU)


def test_aot_key_covers_families_dim_and_seed(tmp_path):
    """Equal input shapes with another interval seed, or another family
    set or interval dim, must miss: a hit would serve verdicts computed
    against the wrong rank draw."""
    n, src, dst, g = _graph(10)
    idx = DBLIndex.build(g, n_cap=n, k=8, k_prime=8, device=CPU, **FAM)
    e1 = QueryEngine(idx, bfs_chunk=64, donate=False)
    e1.aot_warmup(idx, tmp_path)
    assert e1.aot_cache.stores > 0

    # same everything -> all hits
    e2 = QueryEngine(idx, bfs_chunk=64, donate=False)
    e2.aot_warmup(idx, tmp_path)
    assert e2.aot_cache.hits == e1.aot_cache.stores
    assert e2.aot_cache.stores == 0

    # same shapes, another il_seed -> zero hits
    idx_seed = DBLIndex.build(g, n_cap=n, k=8, k_prime=8, device=CPU,
                              families=FAM["families"],
                              il_dim=FAM["il_dim"], il_seed=99)
    assert [tuple(x.shape) for x in (idx_seed.il_in, idx_seed.il_out)] \
        == [tuple(x.shape) for x in (idx.il_in, idx.il_out)]
    e3 = QueryEngine(idx_seed, bfs_chunk=64, donate=False)
    e3.aot_warmup(idx_seed, tmp_path)
    assert e3.aot_cache.hits == 0 and e3.aot_cache.stores > 0

    # families flip -> zero hits (the shapes change too; the key must)
    idx_core = DBLIndex.build(g, n_cap=n, k=8, k_prime=8, device=CPU)
    e4 = QueryEngine(idx_core, bfs_chunk=64, donate=False)
    e4.aot_warmup(idx_core, tmp_path)
    assert e4.aot_cache.hits == 0

    # il_dim flip -> zero hits
    idx_dim = DBLIndex.build(g, n_cap=n, k=8, k_prime=8, device=CPU,
                             families=FAM["families"], il_dim=2,
                             il_seed=FAM["il_seed"])
    e5 = QueryEngine(idx_dim, bfs_chunk=64, donate=False)
    e5.aot_warmup(idx_dim, tmp_path)
    assert e5.aot_cache.hits == 0
