import numpy as np
import pytest

from smarc_navigation_tpu import native
from smarc_navigation_tpu.ops.assignment import _scipy_solve

@pytest.fixture(autouse=True)
def _native_lib():
    """Build/load the library inside the test, never at import (xdist
    workers must collect identical test sets)."""
    if not native.available():
        pytest.skip("no g++ toolchain")


def test_jv_matches_scipy():
    rng = np.random.default_rng(0)
    for _ in range(20):
        R, C = rng.integers(5, 40), rng.integers(2, 5)
        if C > R:
            R, C = C, R
        cost = rng.uniform(0, 10, (R, C))
        a = native.jv_assign(cost)
        s = _scipy_solve(cost)
        ca = cost[a, np.arange(C)].sum()
        cs = cost[s, np.arange(C)].sum()
        assert abs(ca - cs) < 1e-9, (a, s)
        assert len(set(a.tolist())) == C


def test_jv_slam_shaped():
    rng = np.random.default_rng(1)
    for _ in range(10):
        L, M = 64, 8
        cost = np.full((L + M, M), 10000.0)
        for c in range(M):
            rows = rng.choice(L, 3, replace=False)
            cost[rows, c] = rng.uniform(0, 6)
            cost[L + c, c] = 1.0
        a = native.jv_assign(cost)
        s = _scipy_solve(cost)
        assert abs(cost[a, np.arange(M)].sum() - cost[s, np.arange(M)].sum()) < 1e-9


def test_jv_batch():
    rng = np.random.default_rng(2)
    costs = rng.uniform(0, 1, (6, 20, 7))
    outs = native.jv_assign_batch(costs)
    for b in range(6):
        s = _scipy_solve(costs[b])
        assert abs(costs[b][outs[b], np.arange(7)].sum() - costs[b][s, np.arange(7)].sum()) < 1e-9


def test_jv_rejects_bad_shape():
    with pytest.raises(ValueError):
        native.jv_assign(np.zeros((3, 5)))  # C > R


def test_latest_index_matches_numpy():
    rng = np.random.default_rng(3)
    stamps = np.sort(rng.uniform(0, 100, 1000))
    ticks = np.linspace(-1, 101, 777)
    got = native.latest_index(stamps, ticks)
    want = np.searchsorted(stamps, ticks, side="right") - 1
    np.testing.assert_array_equal(got, want)


def test_bin_events_matches_python():
    rng = np.random.default_rng(4)
    M, T, K, D = 500, 200, 4, 3
    stamps = np.sort(rng.uniform(0, 20, M))
    values = rng.normal(size=(M, D))
    burst = np.arange(M)
    ticks = np.linspace(0, 20, T)
    out_v, out_m, dropped = native.bin_events(stamps, values, burst, ticks, K)

    # python oracle (same as the timeline fallback)
    ov = np.zeros((T, K, D))
    om = np.zeros((T, K), bool)
    fill = np.zeros(T, int)
    drop = 0
    tick_of = np.searchsorted(ticks, stamps, side="left")
    for m in range(M):
        t = tick_of[m]
        if t >= T or fill[t] >= K:
            drop += 1
            continue
        ov[t, fill[t]] = values[m]
        om[t, fill[t]] = True
        fill[t] += 1
    np.testing.assert_array_equal(out_m, om)
    np.testing.assert_allclose(out_v, ov, atol=0)
    assert dropped == drop


def test_concurrent_builds_yield_one_loadable_library(tmp_path):
    """Several processes building the library at once (xdist workers on a
    fresh checkout) all end with the same loadable library: builds go to
    a temporary file and are renamed into place under a lock."""
    import shutil
    import subprocess
    import sys

    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(native._SRC, src / "smarcnav_native.cc")
    code = (
        "import sys, numpy as np\n"
        "from smarc_navigation_tpu import native\n"
        f"native._SRC = {str(src / 'smarcnav_native.cc')!r}\n"
        f"native._LIB = {str(src / 'libsmarcnav.so')!r}\n"
        "native._STAMP = native._LIB + '.srchash'\n"
        "native._LOCK = native._LIB + '.lock'\n"
        "assert native.available()\n"
        "print(native.jv_assign(np.array([[1.0, 5.0], [4.0, 1.0]])).tolist())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[0, 1]"
    leftovers = sorted(f.name for f in src.iterdir())
    assert leftovers == ["libsmarcnav.so", "libsmarcnav.so.lock",
                         "libsmarcnav.so.srchash", "smarcnav_native.cc"]
