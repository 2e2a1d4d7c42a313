"""The frozen budget rule and recording reader against the port's own
code on small recordings (the tests may import both; the benchmark's
runs read only the frozen copy)."""
import numpy as np
import pytest

from portbench.reference import budget_rule
from portbench.reference.recording import Recording

import pb_synth


@pytest.mark.parametrize("kernel,problem", [
    ("hotspot", pb_synth.HOT_SMALL),            # 328 configs
    ("hotspot", {"h": 4096, "w": 4096}),        # 5,040: the long builder
])
def test_budget_rule_is_make_scorers(tmp_path, kernel, problem):
    from repro_torch.core.cache import CacheFile
    from repro_torch.core.methodology import make_scorer
    path = pb_synth.write_recording(tmp_path / "r.json.gz", kernel, problem,
                                    seed=3)
    rec = Recording.load(str(path))
    ours = budget_rule.budget_seconds(rec.kernel, rec.device, rec.time_s,
                                      rec.charge_s)
    theirs = make_scorer(CacheFile.load(str(path)), engine="vectorized")
    assert ours == theirs.budget_s


def test_recording_rows_are_the_ports(tmp_path):
    """Rows, value indices, the flat lookup and each row's column come
    out as the port derives them from the same file."""
    from repro_torch.core.cache import CacheFile
    from repro_torch.kernels import get_kernel
    path = pb_synth.write_recording(tmp_path / "r.json.gz", "hotspot",
                                    pb_synth.HOT_SMALL, seed=4)
    rec = Recording.load(str(path))
    space = get_kernel("hotspot").space(pb_synth.HOT_SMALL)
    cache = CacheFile.load(str(path), space=space)
    cs = space.compiled
    assert [rec.keys[c] for c in rec.col_of_row] == list(cs.ids)
    assert np.array_equal(rec.vidx, cs.vidx)
    assert np.array_equal(rec.row_of_flat, cs.row_of_flat)
    assert np.array_equal(rec.strides, cs.strides_np)
    assert np.array_equal(rec.col_of_row, cache.columns.rows_for_space(cs))
    assert np.array_equal(rec.charge_s, cache.columns.charge_s)
    assert np.array_equal(rec.time_s, cache.columns.time_s)
