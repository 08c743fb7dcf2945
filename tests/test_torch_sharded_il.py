"""The "il" interval family on the port's vertex-sharded layout over 4
gloo ranks on the CPU, held bitwise against the JAX package's replicated
index and the port's: the rank planes are row-partitioned like the bool
planes and built, inserted into and rebuilt through the MIN halo
fixpoint and the MIN seed scatter.

Runs itself as a script in a subprocess, as
``tests/test_torch_sharded_planes.py`` does (its rank harness and
runners).  The cases twin ``tests/distributed/run_sharded_il.py``'s
``lifecycle`` without its ``sharded_il_rows`` step and ``engine_stream``
(``tests/test_torch_sharded_engine.py`` twins those), then run the same
lifecycle with word planes."""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.graphs.generators import power_law
from tests.test_torch_sharded_planes import (K, assert_case, finish_world,
                                             replay, script_main,
                                             start_world)

FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=7)


def _lifecycle(run, plane_repr):
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=3)
    pr = dict(plane_repr=plane_repr)
    run.build("build", run.graph(src, dst, n, m + 512), n_cap=n, **K,
              **FAM, **pr)
    rng = np.random.default_rng(0)
    # the reference's sharded_il_rows batch, drawn so the inserts get the
    # reference's edges
    rng.integers(0, n, 100), rng.integers(0, n, 100)
    prev = "build"
    for r in range(3):
        ns = rng.integers(0, n, 32).astype(np.int32)
        nd = rng.integers(0, n, 32).astype(np.int32)
        run.insert(f"insert{r}", prev, ns, nd, max_iters=64, **pr)
        prev = f"insert{r}"
    run.delete("delete", prev, src[10:60], dst[10:60])
    run.rebuild("delta", "delete", mode="delta", max_iters=64, **pr)
    run.rebuild("full", "delete", mode="full", max_iters=64, **pr)
    ns = rng.integers(0, n, 16).astype(np.int32)
    nd = rng.integers(0, n, 16).astype(np.int32)
    run.insert("insert_after_delta", "delta", ns, nd, max_iters=64, **pr)


def lifecycle(run):
    """build -> 3 inserts -> delete -> delta and full rebuild -> insert
    after the delta rebuild, with interval planes."""
    _lifecycle(run, "bool")


def lifecycle_packed(run):
    """The same with the OR fixpoints on word planes."""
    _lifecycle(run, "packed")


CASES = {f.__name__: f for f in (lifecycle, lifecycle_packed)}


@pytest.fixture(scope="module")
def world():
    proc, out_dir = start_world(Path(__file__), list(CASES))
    try:
        reps = replay(CASES, list(CASES))
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return finish_world(proc, out_dir), reps


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_il_lifecycle_bitwise(world, case, ref):
    ranks, reps = world
    assert_case(ranks, reps[ref], case, f"{case} vs {ref}")


def test_interval_planes_are_sharded_and_counted(world):
    ranks, reps = world
    rep = reps["torch"]
    for step in ("build", "delta", "full"):
        key = f"lifecycle|{step}|il_in"
        rows = [r[key].shape[0] for r in ranks]
        assert rows == [rep[key].shape[0] // 4] * 4
        assert rep[key].dtype == np.int32
    # rounds: fwd, bwd, il in, il out at every step that runs fixpoints
    for step in ("build", "insert0", "delta", "full"):
        assert ranks[0][f"lifecycle|{step}|rounds"].shape == (4,)


if __name__ == "__main__":
    script_main(sys.argv[1:], CASES)
