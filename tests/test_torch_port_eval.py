"""The port's evaluation modules against the JAX package's on the CPU:
DTW (`eval.dtw`), the oversmoothing metrics and MCD, the analytic FLOP
counts (`eval.flops`, also against `torch.utils.flop_counter` on a narrow
HiFi-GAN), the card's peak table, the figures (`eval.plotting`), and the
port's profiling helpers (`runtime.profiling`)."""
import dataclasses

import numpy as np
import pytest
import torch

from tts_arabic_torch import eval as port_eval
from tts_arabic_torch.eval import flops as port_flops
from tts_arabic_torch.eval import plotting
from tts_arabic_torch.models.fastpitch import FastPitchConfig
from tts_arabic_torch.models.layers import init_weights
from tts_arabic_torch.models.tacotron2 import Tacotron2Config
from tts_arabic_torch.runtime import profiling
from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tts_arabic_tpu import eval as jax_eval
from tts_arabic_tpu.eval import dtw as jax_dtw
from tts_arabic_tpu.eval import flops as jax_flops
from tts_arabic_tpu.models.fastpitch import FastPitchConfig as JaxFPConfig
from tts_arabic_tpu.models.tacotron2 import Tacotron2Config as JaxT2Config
from tts_arabic_tpu.vocoder.hifigan import HiFiGANConfig as JaxHiFiConfig

REL = 1e-6
SMALL_FP = dict(d_model=64, enc_n_layers=2, dec_n_layers=2,
                enc_filter_size=128, dec_filter_size=128, dur_filter_size=32,
                pitch_filter_size=32, energy_filter_size=32)
SMALL_T2 = dict(n_symbols=40, symbol_embedding_dim=32,
                encoder_embedding_dim=32, decoder_rnn_dim=48,
                attention_rnn_dim=48, attention_hidden_dim=16,
                attention_location_n_filters=4,
                attention_location_kernel_size=7, prenet_dim=16,
                postnet_embedding_dim=32, postnet_n_convolutions=3)
SMALL_HIFI = dict(upsample_rates=(8, 8, 2, 2),
                  upsample_kernel_sizes=(16, 16, 4, 4),
                  upsample_initial_channel=64)


def _mels(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(-4, 2, s).astype(np.float32) for s in shapes]


# test_eval.py's metrics and windows
@pytest.mark.parametrize("metric,window", [("l2", -1), ("cosine", -1),
                                           ("l2", 8), ("cosine", 8)])
def test_dtw_equals_jax_numpy_recurrence(metric, window):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 12)).astype(np.float32)
    B = rng.standard_normal((55, 12)).astype(np.float32)
    mcode = 0 if metric == "l2" else 1
    cost_ref, path_ref = jax_dtw._dtw_numpy(A, B, mcode, window)
    cost, path = port_eval.dtw_path(A, B, metric=metric,
                                    window=None if window < 0 else window)
    # the port's native recurrence sums in index order, numpy pairwise
    assert cost == pytest.approx(cost_ref, rel=1e-5)
    np.testing.assert_array_equal(path, path_ref)
    assert port_eval.using_native_kernel()


def test_dtw_align_mels_equals_jax():
    mel_a, mel_b = _mels(2, [(80, 60), (80, 47)])
    got = port_eval.dtw_align_mels(mel_a, mel_b)
    A = np.ascontiguousarray(mel_a.T)
    B = np.ascontiguousarray(mel_b.T)
    cost, path = jax_dtw._dtw_numpy(A, B, 1, -1)
    assert got[0] == pytest.approx(cost, rel=1e-5)
    np.testing.assert_array_equal(got[1], path)
    np.testing.assert_array_equal(got[2], A[path[:, 0]])
    np.testing.assert_array_equal(got[3], B[path[:, 1]])
    same = port_eval.dtw_align_mels(mel_a, mel_a)
    np.testing.assert_array_equal(same[1][:, 0], same[1][:, 1])
    assert port_eval.dtw_align_mels(mel_a, mel_b, return_aligned=False)[
        0] == got[0]


def test_oversmoothing_metrics_and_mcd_equal_jax():
    mel_a, mel_b = _mels(5, [(80, 90), (80, 74)])
    for reduction in ("none", "median", "mean"):
        got = port_eval.compute_mel_oversmoothing_metrics(
            mel_a, reduction=reduction)
        want = jax_eval.compute_mel_oversmoothing_metrics(
            mel_a, reduction=reduction)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    np.testing.assert_allclose(port_eval.framewise_rfft_power(mel_a),
                               jax_eval.framewise_rfft_power(mel_a), rtol=REL)
    got = port_eval.oversmoothing_metrics_aligned(mel_a, mel_b)
    want = jax_eval.oversmoothing_metrics_aligned(mel_a, mel_b)
    assert got.keys() == want.keys() and len(got) == 8
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    series = np.random.default_rng(6).normal(size=30)
    np.testing.assert_allclose(
        port_eval.aligned_mae_distance(series, series[::-1].copy()),
        jax_eval.aligned_mae_distance(series, series[::-1].copy()),
        rtol=REL)
    for b in (mel_b, mel_a + 0.3, mel_a):
        np.testing.assert_allclose(port_eval.mcd(mel_a, b),
                                   jax_eval.mcd(mel_a, b), rtol=REL,
                                   atol=1e-12)
    assert port_eval.mcd(mel_a, mel_a) < 1e-5


@pytest.mark.parametrize("size", ["default", "small"])
def test_flop_counts_equal_jax(size):
    small = size == "small"
    fp = FastPitchConfig(**SMALL_FP) if small else FastPitchConfig()
    jfp = JaxFPConfig(**SMALL_FP) if small else JaxFPConfig()
    t2 = Tacotron2Config(**SMALL_T2) if small else Tacotron2Config()
    jt2 = JaxT2Config(**SMALL_T2) if small else JaxT2Config()
    hifi = HiFiGANConfig(**SMALL_HIFI) if small else HiFiGANConfig()
    jhifi = JaxHiFiConfig(**SMALL_HIFI) if small else JaxHiFiConfig()
    jax_fields = dataclasses.asdict(jfp)
    assert all(jax_fields[k] == v for k, v in dataclasses.asdict(fp).items())
    for n in (7, 48, 300):
        pairs = [
            (port_flops.fft_stack_flops(n, 6, 384, 1, 64, 1536, 3),
             jax_flops.fft_stack_flops(n, 6, 384, 1, 64, 1536, 3)),
            (port_flops.fastpitch_encode_flops(fp, n),
             jax_flops.fastpitch_encode_flops(jfp, n)),
            (port_flops.fastpitch_decode_flops(fp, n, 4 * n),
             jax_flops.fastpitch_decode_flops(jfp, n, 4 * n)),
            (port_flops.hifigan_flops(n, hifi),
             jax_flops.hifigan_flops(n, jhifi)),
            (port_flops.vocos_flops(n), jax_flops.vocos_flops(n)),
            (port_flops.vocos_flops(n, dim=64, intermediate_dim=128,
                                    num_layers=2),
             jax_flops.vocos_flops(n, dim=64, intermediate_dim=128,
                                   num_layers=2)),
            (port_flops.tacotron2_flops(t2, n, 5 * n),
             jax_flops.tacotron2_flops(jt2, n, 5 * n)),
        ]
        for got, want in pairs:
            assert isinstance(got, int) and got == want > 0


def test_hifigan_flops_equal_torch_flop_counter():
    """`hifigan_flops` counts what PyTorch's FLOP counter counts in one
    forward of a narrow generator on the CPU (conv_pre, the transposed
    convs, every ResBlock conv, conv_post)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = HiFiGANConfig(**SMALL_HIFI)
    gen = init_weights(Generator(cfg), 0).eval()
    mel = torch.zeros(2, 19, cfg.num_mels)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        gen(mel)
    assert counter.get_total_flops() == 2 * port_flops.hifigan_flops(19, cfg)


def test_peak_table_answers_for_the_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert port_flops.chip_peak_flops() == 989e12
    assert port_flops.chip_peak_flops(0, "bf16") == 989e12
    assert port_flops.chip_peak_flops(0, "tf32") == 495e12
    assert port_flops.chip_peak_flops(0, "fp32") == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Quantum9000")
    assert port_flops.chip_peak_flops() is None


def test_plotting_returns_figures():
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    figs = [plotting.plot_mel(rng.normal(size=(80, 40))),
            plotting.plot_alignment(rng.random((40, 12))),
            plotting.plot_mel_triptych(rng.normal(size=(80, 40)),
                                       None, rng.normal(size=(80, 40))),
            plotting.plot_mel_triptych(rng.normal(size=(80, 40)))]
    import matplotlib.pyplot as plt
    for fig, n_axes in zip(figs, (2, 2, 4, 2)):    # each with a colorbar
        assert len(fig.axes) == n_axes
        plt.close(fig)


def test_profiling_on_the_cpu(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        with profiling.span("matmul"):
            return {"y": [torch.ones(64, 64) @ torch.ones(64, 64)]}

    timing = profiling.benchmark(fn, warmup=2, iters=5)
    assert len(calls) == 7 and len(timing.times_s) == 5
    assert timing.device == "cpu" and timing.best_s <= timing.median_s
    assert timing.spread_s >= 0 and "median" in str(timing)
    tree = fn()
    assert profiling.block(tree) is tree
    profiling.clear()
    with profiling.trace(tmp_path / "trace") as prof:
        fn()
    assert (tmp_path / "trace" / "trace.json").is_file()
    # the span is recorded under the profiler, and is none of its events
    assert [s.name for s in profiling.recorded()] == ["matmul"]
    assert not any(e.key == "matmul" for e in prof.key_averages())
    profiling.clear()
