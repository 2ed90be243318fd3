"""The port's Tab. 5.2 serving rows against the JAX package's, on the CPU.

``repro_torch.benchmarks.tab52_qps.run_serving(device="cpu")`` and
``benchmarks/bench_tab52_qps.run_serving()`` run once each, at their
defaults (V = 1,000,000, 64 batches), in one module fixture.  Both are
seeded and pull-based, so every column but the host latencies is
deterministic: the port's must equal the reference's exactly, and both
equal the values recorded below.  Latencies are held nowhere.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.benchmarks import tab52_qps

ROOT = Path(__file__).resolve().parents[1]

# the gated columns of each row, and what the reference printed
# (jax 0.9.0 on the CPU)
GATED = {
    "tab52.serving.hot_cache": {
        "hit_rate": "0.8492", "vocab": "1000000", "cache_rows": "512",
        "audit_cache_bytes": "1048576", "audit_hit_skips_kernel": "1",
        "audit_race_findings": "0"},
    "tab52.serving.live_sync": {
        "hit_rate": "0.8079", "freshness_lag_steps": "2", "syncs": "8",
        "coalesced": "8", "invalidations": "221", "versions": "9",
        "audit_race_findings": "0"},
}
LATENCY = ("p50_us", "p99_us")


def _reference():
    sys.path.insert(0, str(ROOT))
    try:
        return __import__("benchmarks.bench_tab52_qps", fromlist=["run"])
    finally:
        sys.path.remove(str(ROOT))


def _rows(rows: list[str]) -> dict:
    """name -> {column: value} of each CSV row."""
    out = {}
    for row in rows:
        name, _, derived = row.split(",", 2)
        out[name] = dict(kv.split("=") for kv in derived.split(";"))
    return out


@pytest.fixture(scope="module")
def both():
    return (_rows(tab52_qps.run_serving(device="cpu")),
            _rows(_reference().run_serving()))


@pytest.mark.parametrize("name", list(GATED))
def test_serving_row_equals_the_reference(both, name):
    got, want = both
    assert list(got) == list(want) == list(GATED)
    assert got[name].keys() == want[name].keys()
    assert set(got[name]) == set(GATED[name]) | set(LATENCY)
    for col, value in GATED[name].items():
        assert got[name][col] == want[name][col] == value, col


def test_hot_batches_are_the_reference_draws():
    ref = _reference()
    hot = np.arange(tab52_qps.SERVE_HOT, dtype=np.int64)
    got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        got = tab52_qps._hot_batch(got_rng, hot)
        assert got.shape == (tab52_qps.SERVE_B, tab52_qps.SERVE_F)
        np.testing.assert_array_equal(got, ref._hot_batch(want_rng, hot))
    for name in ("SERVE_V", "SERVE_DIM", "SERVE_HOT", "SERVE_CACHE",
                 "SERVE_B", "SERVE_F", "SERVE_SYNC_EVERY",
                 "SERVE_PUBS_PER_SYNC", "SERVE_TOUCH"):
        assert getattr(tab52_qps, name) == getattr(ref, name), name
