"""The rest of a run, past the look for a card, with the timed path
broken underneath: `correct` must come out false for every fault a cell
can have, and true for the sound run.

The faults: an answer altered where the executor produces it; half of
the rows left out (every other shard of lineitem dropped from the scans
once the data is loaded).  A step that returns its state unchanged has
no counterpart here: the traffic is read-only, and an unchanged answer
is the right one.  No cell runs across positions, so none can leave out
an exchange."""

import numpy as np
import pytest

CELLS = ("tpch_sf1.q3_dash", "tpch_sf1.groupby_rollup")


def failed_checks(checks):
    return {k: (v, lim) for k, v, lim in checks if v > lim}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(run_cpu, name):
    from portbench import spec

    result, checks = run_cpu(name)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {
        m.name for m in spec.find_cell(name).end_to_end}
    assert {"queries_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(run_cpu, name, monkeypatch):
    from citus_tpu_torch.executor import runner

    real = runner.Executor._host_combine

    def altered(self, *a, **k):
        res = real(self, *a, **k)
        for name in res.column_names:
            col = np.array(res.columns[name])
            if res.row_count and col.dtype.kind == "f":
                col[0] = col[0] * 1.01 + 1.0
                res.columns[name] = col
                break
        return res

    def plant(_sess):
        monkeypatch.setattr(runner.Executor, "_host_combine", altered)

    result, checks = run_cpu(name, hooks={"after_load": plant})
    assert not result["correct"] and failed_checks(checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_half_the_rows_left_out_is_not_correct(run_cpu, name, monkeypatch):
    from citus_tpu_torch.catalog.catalog import Catalog

    real = Catalog.table_shards

    def half(self, table):
        out = real(self, table)
        return out[::2] if table == "lineitem" else out

    def plant(_sess):
        monkeypatch.setattr(Catalog, "table_shards", half)

    result, checks = run_cpu(name, hooks={"after_load": plant})
    assert not result["correct"] and failed_checks(checks), checks

