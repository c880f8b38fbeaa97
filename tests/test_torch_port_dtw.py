"""The port's native DTW (`csrc/dtw.cc`, built by `ops.build.host_library`,
called by `eval.dtw.dtw_path`) against its plain version `_dtw_numpy` and
the JAX package's `dtw_path`: both metrics, with and without a
Sakoe-Chiba window (one too narrow to reach the end as well), ragged
lengths with Ta < Tb, Ta > Tb and Ta = Tb. Costs within 1e-5 relative (the
native sums run in index order, numpy's pairwise), paths equal. A library
that cannot be built raises; nothing falls back."""
import numpy as np
import pytest

from tts_arabic_torch.eval import dtw as port_dtw
from tts_arabic_torch.ops import build
from tts_arabic_tpu.eval import dtw as jax_dtw

SHAPES = [(40, 55), (63, 31), (47, 47), (1, 9), (12, 1)]


def _seqs(Ta, Tb, M=20, seed=0):
    rng = np.random.default_rng(seed + 97 * Ta + Tb)
    return (rng.standard_normal((Ta, M)).astype(np.float32),
            rng.standard_normal((Tb, M)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("window", [None, 6, 30])
@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_native_dtw_equals_numpy_and_jax(metric, window, Ta, Tb):
    A, B = _seqs(Ta, Tb)
    mcode = 0 if metric == "l2" else 1
    cost, path = port_dtw.dtw_path(A, B, metric, window)
    plain = port_dtw._dtw_numpy(A, B, mcode, -1 if window is None else window)
    jax_cost, jax_path = jax_dtw.dtw_path(A, B, metric, window)
    for want_cost, want_path in (plain, (jax_cost, jax_path)):
        assert cost == pytest.approx(want_cost, rel=1e-5)
        np.testing.assert_array_equal(path, want_path)
    assert path.dtype == np.int32 and path.shape[1] == 2
    if window is not None and abs(Ta - Tb) > window:
        assert cost >= 1e29 and len(path) == 0   # the end is unreachable
    else:
        assert tuple(path[0]) == (0, 0) and tuple(path[-1]) == (Ta - 1,
                                                                Tb - 1)


def test_library_is_built_under_a_hashed_name_and_used():
    assert port_dtw.using_native_kernel()
    lib = build.host_library("dtw")
    assert lib is build.host_library("dtw")
    assert list(build.BUILD_DIR.glob("libdtw_*.so"))


def test_a_failed_build_raises(monkeypatch):
    def broken(name):
        raise RuntimeError(f"building {name}.cc failed")

    monkeypatch.setattr(port_dtw, "host_library", broken)
    A, B = _seqs(5, 6)
    with pytest.raises(RuntimeError, match="failed"):
        port_dtw.dtw_path(A, B)
    with pytest.raises(RuntimeError, match="failed"):
        port_dtw.using_native_kernel()


def test_malformed_inputs_are_refused():
    A, B = _seqs(5, 6)
    with pytest.raises(ValueError, match="one width"):
        port_dtw.dtw_path(A, B[:, :7])
    with pytest.raises(ValueError, match="refused"):
        port_dtw.dtw_path(A[:0], B)
