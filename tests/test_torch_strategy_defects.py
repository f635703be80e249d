"""The graph-level wrong-reshard defects under the port's cascade against
the JAX package's (tests/test_static_analysis.py:256-305), at four ranks
(the port's gloo processes; the JAX package on four virtual devices),
with the helpers and cases of tests/test_torch_strategy_safety.py: a
duplicated reduction on the hybrid plan's row-parallel layer is rejected
by ShardLint (FF001) with no probe of it; with the static stage off the
audit catches it (x4 under the mesh); a dropped reduction is invisible to
the audit in both packages (the port's row-parallel linear sums its
partials itself, as XLA re-derives the psum)."""
import pytest

from test_torch_strategy_safety import (DEFECTS, same_path_on_every_rank,
                                        w4_runs, _ranks)


@pytest.fixture(scope="module")
def defects(tmp_path_factory):
    return w4_runs(tmp_path_factory, DEFECTS)


@pytest.mark.parametrize("name", DEFECTS)
def test_the_defect_cascade_takes_the_jax_path_on_every_rank(defects, name):
    same_path_on_every_rank(defects, name)


def test_static_stage_rejects_the_duplicate_without_a_probe(defects):
    """FF001 names the injected node on the hybrid winner; the one probe
    is the fallback's (``compile_probes`` 1), as in the JAX package."""
    root, want = defects
    g = _ranks(root, "static_dup")[0]
    assert list(g["rules"]) == ["FF001"]
    assert g["counters"][:4].tolist() == [2, 1, 1, 1]
    assert "FF001" in str(g["reasons"][0]) and \
        "chaos_dup_reduction" in str(g["reasons"][0])
    assert str(g["final"]) == "mesh=(4,) remat=full"


def test_audit_catches_the_duplicated_reduction_when_static_is_off(defects):
    root, want = defects
    g = _ranks(root, "dynamic_dup")[0]
    assert g["counters"].tolist()[3:] == [1, 2, 1]
    assert "chaos_dup_reduction" in str(g["defect"])
    assert g["reports"][0, 4] == 0 and g["reports"][-1, 4] == 1
    # x4 under the mesh: the candidate's probe is off, the reference not
    assert abs(g["reports"][0, 2] / g["reports"][0, 3] - 1) > 0.05


def test_dropped_reduction_is_invisible_to_the_audit_as_in_jax(defects):
    """The port's row-parallel linear sums its partials itself, so a
    dropped reduction changes no value, as XLA re-derives the psum in the
    JAX package: the audit passes with no fallback in both."""
    root, want = defects
    g = _ranks(root, "drop")[0]
    assert "dropped" in str(g["defect"])
    assert g["counters"].tolist()[3:] == [0, 1, 0] == \
        want["drop"]["counters"][3:]
    assert g["reports"][0, 4] == 1
