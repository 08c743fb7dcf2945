"""The comparison that decides ``correct``: a sound run passes; the timed
path broken underneath (a step that leaves the state unchanged, half a
batch answered from the other half, an answer altered where it is
produced) and the control (updates deferred past the window) fail.  The
cells run on one chip, so there is no exchange between chips to leave
out."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from reachbench import check
from reachbench.system import System

from .conftest import run_tiny

CELLS = ["lj.read", "wikitalk.ingest", "wikitalk.churn"]


class Unchanged(System):
    """Updates acknowledged and dropped: the state stays as it was."""

    def insert(self, s, d):
        pass

    def delete(self, s, d):
        pass


class HalfBatch(System):
    """The second half of each batch answered with the first half's
    answers."""

    def query(self, u, v):
        half = len(u) // 2
        ans = np.asarray(super().query(u[:half], v[:half]), bool)
        return np.concatenate([ans, ans])[:len(u)]


class Altered(System):
    """One answer of each batch flipped where it is produced."""

    def query(self, u, v):
        ans = np.array(super().query(u, v), bool)
        ans[len(ans) // 3] ^= True
        return ans


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["compare"]
    assert res["compare"]["lanes_checked"] > 0
    assert res["checks"]["mismatches"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered],
                         ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(cell, fault):
    res = run_tiny(cell, system_factory=fault)
    assert not res["correct"]
    assert res["compare"]["mismatches"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_tiny(cell)
    cmp = check.compare(2**31 + 11, res["answered"], res["ledger"],
                        res["uniform"], 400,
                        {"batches": 64, "lanes": 1 << 20,
                         "read_back_batches": 64},
                        torch.device("cpu"), t_window=res["t_window"])
    assert cmp["mismatches"] == 0
    assert cmp["read_back_lanes"] > 0
    assert cmp["control_depth2_mismatches"] > 0
    assert cmp["control_frozen_mismatches"] > 0
    assert cmp["control_lag1_mismatches"] > 0


class Raising(System):
    """The second insert (the first of the window) raises."""
    calls = 0

    def insert(self, s, d):
        Raising.calls += 1
        if Raising.calls > 1:
            raise RuntimeError("planted")
        super().insert(s, d)


def test_a_failed_call_ends_the_window_and_is_not_correct():
    res = run_tiny("lj.read", system_factory=Raising)
    assert not res["correct"]
    assert res["failed"] == 1
    assert res["checks"]["failed_calls"] == {"value": 1, "limit": 0}
