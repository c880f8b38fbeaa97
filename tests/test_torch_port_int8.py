"""The port's int8 serving path against the JAX package's, on the CPU in
f32: `ops.int8.int8_conv_static`, the MRF calibration and int8 generator
(`ops.hifigan_int8`), the decoder ConvFFN's int8 hooks, and
`calibrate_int8` / `quantize="int8"` of both pipelines.

Weights are seeded and written as reference `.pth` files
(`torch_port_weights.py`) that both packages load: a narrow FastPitch, a
HiFi-GAN with V1's kernels, dilations and rates on 128 initial channels
(its C = 64 stage is the one int8 claims, 18 sites; conv_post scaled
300-fold, so the waves peak near 0.1) and JAX's small Tacotron2.

Where both sides quantize the same float input with the same scale they
agree exactly: the int8 grids and int32 accumulators are equal. Through a
whole generator or pipeline they do not: their float ops (conv_pre, the
upsamples, attention) differ in the last bits, and an input that lands
within that much of a rounding tie takes the neighbouring grid value on
one side. So the whole-generator checks are made twice: fed, site by
site, the JAX package's conv inputs (then within 1e-5 of its peak), and
free-running, where every grid value is equal or one step off at a
handful of ties and the wave stays above PIPE_SNR against JAX's. The same
holds within the port: a stream window's float ops round a few ties
apart from the whole call's, so an int8 stream is held against its
tts_single at PIPE_SNR (the float stream, at 2e-5, in
test_torch_port_stream.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_weights import (SMALL_TACOTRON2, write_int8_vocoder,
                                write_tacotron2_weights, write_weights)
from tts_arabic_torch.infer import FastPitch2Wave as PortPipe
from tts_arabic_torch.infer import Tacotron2Wave as PortWave
from tts_arabic_torch.models import convert
from tts_arabic_torch.models.layers import FFTransformer
from tts_arabic_torch.models.tacotron2 import Tacotron2Config
from tts_arabic_torch.ops import hifigan_int8 as port_h8
from tts_arabic_torch.ops import int8 as port_int8
from tts_arabic_tpu.infer import FastPitch2Wave as JaxPipe
from tts_arabic_tpu.infer import Tacotron2Wave as JaxWave
from tts_arabic_tpu.ops import hifigan_int8 as jax_h8
from tts_arabic_tpu.ops import int8 as jax_int8

TEXT = "bisomi {ll~ahi {lr~aHoma`ni {lr~aHiymi"
T2_TEXT = "marHaban bikum"
T2_STEPS = 96
# two int8 runs with the same scales whose float ops differ in the last
# bits (the JAX package's and the port's; a stream and its tts_single):
# the ties that round apart leave the waves this close (SNR, dB; 47-51 dB
# measured on these weights). The int8 path itself is ~20 dB from the
# float one here
PIPE_SNR = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snr_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2),
                                                1e-30))


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8")
    fp, _, _ = write_weights(d, duration_bias=1.0)
    voc, voc_cfg = write_int8_vocoder(d, gain=300.0)
    t2_config = Tacotron2Config(**dict(SMALL_TACOTRON2, prenet_dropout=0.0))
    return dict(fp=fp, t2=write_tacotron2_weights(d, t2_config),
                voc=dict(vocoder_sd=voc, vocoder_config=voc_cfg,
                         arabic_in=False))


# ---- ops.int8 --------------------------------------------------------------

@pytest.mark.parametrize("scale_kind", ["float", "f32 tensor"])
@pytest.mark.parametrize("dilation", [1, 3, 5])
def test_int8_conv_matches_jax(dilation, scale_kind):
    """Equal int8 grids, equal int32 accumulators, outputs within 1e-6 of
    the peak: a python-float scale (the MRF sites) and an f32 tensor (the
    FFN's, whose reciprocal JAX takes in f32)."""
    rng = np.random.default_rng(dilation)
    y = (rng.standard_normal((2, 64, 48)) * 3).astype(np.float32)
    kernel = (rng.standard_normal((7, 48, 40)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    ascale = float(np.abs(y).max()) / 127.0
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1,
                                                                    0)))
    scale = (ascale if scale_kind == "float"
             else torch.tensor(ascale, dtype=torch.float32))
    jscale = ascale if scale_kind == "float" else jnp.float32(ascale)

    wq, wscale = jax_int8.weight_qparams(jnp.asarray(kernel))
    xq = jnp.clip(jnp.round(jnp.asarray(y) * (1.0 / jscale)), -127,
                  127).astype(jnp.int8)
    pad = 6 * dilation // 2
    acc = jax_int8.jax.lax.conv_general_dilated(
        xq, wq, (1,), [(pad, pad)], rhs_dilation=(dilation,),
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.int32)

    pwq, pwscale = port_int8.weight_qparams(weight)
    np.testing.assert_array_equal(pwq.numpy(),
                                  np.asarray(wq).transpose(2, 1, 0))
    np.testing.assert_array_equal(pwscale.numpy(), np.asarray(wscale))
    pxq = port_int8.quantize(torch.from_numpy(y), scale)
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
    gemm_w, _ = port_int8.gemm_weight(weight)
    pacc = port_int8.int8_conv_acc(pxq, gemm_w, 7, dilation)
    assert pacc.dtype == torch.int32
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(acc))

    got = port_int8.int8_conv_static(torch.from_numpy(y), weight,
                                     torch.from_numpy(bias), dilation, scale)
    want = jax_int8.int8_conv_static(jnp.asarray(y), jnp.asarray(kernel),
                                     jnp.asarray(bias), dilation, jscale)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), 1e-6)
    # bf16 in, bf16 out, on the same grid as the f32 input rounded to bf16
    half = port_int8.int8_conv_static(torch.from_numpy(y).bfloat16(), weight,
                                      torch.from_numpy(bias), dilation, scale)
    assert half.dtype == torch.bfloat16


def test_gemm_weight_is_kept_until_the_weight_changes():
    conv = torch.nn.Conv1d(8, 8, 3)
    first = port_int8.gemm_weight(conv.weight)
    assert port_int8.gemm_weight(conv.weight) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = port_int8.gemm_weight(conv.weight)
    assert again is not first
    np.testing.assert_array_equal(again[0].numpy(), first[0].numpy())
    np.testing.assert_allclose(again[1].numpy(), 2 * first[1].numpy())


# ---- ops.hifigan_int8 ------------------------------------------------------

@pytest.fixture(scope="module")
def vocoders(weights):
    """The int8 vocoder in both packages, and a mel in the log-mel range."""
    from tts_arabic_tpu.models.torch_import import hifigan_params_from_torch
    from tts_arabic_tpu.vocoder.hifigan import HiFiGANConfig as JaxConfig
    from tts_arabic_torch.models.convert import load_reference_pth
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    voc = weights["voc"]
    sd, _ = load_reference_pth(voc["vocoder_sd"])
    gen = Generator(HiFiGANConfig.from_json(voc["vocoder_config"]))
    gen.load_state_dict(sd)
    jcfg = JaxConfig.from_json(voc["vocoder_config"])
    jvars = hifigan_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                      jcfg)
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 40, 80)).astype(np.float32)
    mel = (mel + np.linspace(-2, 2, 80)) * 1.5 - 5.0
    return gen.eval(), jvars, jcfg, mel.astype(np.float32)


def test_collect_mrf_scales_matches_jax(vocoders):
    gen, jvars, jcfg, mel = vocoders
    want = jax_h8.collect_mrf_scales(jvars, [mel, 2 * mel], jcfg,
                                     margin=1.1)
    got = port_h8.collect_mrf_scales(
        gen, [torch.from_numpy(mel), torch.from_numpy(2 * mel)], margin=1.1)
    assert len(got) == 18 and sorted(got) == sorted(want)
    assert all(isinstance(v, float) for v in got.values())
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    with pytest.raises(ValueError, match="min_ch"):
        port_h8.collect_mrf_scales(gen, torch.from_numpy(mel), min_ch=32)
    with pytest.raises(ValueError, match="no MRF stage"):
        port_h8.collect_mrf_scales(gen, torch.from_numpy(mel), min_ch=256)


class _JaxRecorder(jax_h8._Int8MRF):
    """JAX's int8 pass, keeping each site's conv input."""

    def __init__(self, scales, min_ch=64):
        super().__init__(scales, min_ch)
        self.inputs = {}

    def conv(self, site, y, kernel, bias, dilation):
        self.inputs[site] = np.asarray(y)
        return super().conv(site, y, kernel, bias, dilation)


class _PortFed(port_h8._Int8MRF):
    """The port's int8 pass on JAX's conv input at each site (`fed`), or
    on its own, keeping its int8 grids."""

    def __init__(self, scales, fed=None):
        super().__init__(scales, 64)
        self.fed, self.grids = fed, {}

    def conv(self, site, y, conv, dilation):
        if self.fed is not None:
            y = torch.from_numpy(np.array(self.fed[site]))
        self.grids[site] = port_int8.quantize(y, self.scales[site]).numpy()
        return super().conv(site, y, conv, dilation)


def test_generator_apply_int8_matches_jax(vocoders):
    """JAX's scales injected into the port's int8 generator: fed JAX's
    conv inputs it gives JAX's wave within 1e-5 of the peak; running free,
    its grids equal JAX's but for one-step flips at ties, and its wave is
    above 40 dB SNR against JAX's."""
    gen, jvars, jcfg, mel = vocoders
    scales = jax_h8.collect_mrf_scales(jvars, mel, jcfg)
    rec = _JaxRecorder(scales)
    want = np.asarray(jax_h8.generator_apply_pallas(
        jvars, jnp.asarray(mel), jcfg, strategy="xla",
        resblock_override=rec))
    jax_grids = {s: np.asarray(jnp.clip(jnp.round(
        jnp.asarray(y) * (1.0 / scales[s])), -127, 127)).astype(np.int8)
        for s, y in rec.inputs.items()}
    mel_t = torch.from_numpy(mel)
    with torch.no_grad():
        fed = _PortFed(scales, rec.inputs)
        got = gen(mel_t, resblock_override=fed).numpy()
        _close(got, want, 1e-5)
        free = _PortFed(scales)
        got = gen(mel_t, resblock_override=free).numpy()
        ref = port_h8.generator_apply_int8(gen, mel_t, scales).numpy()
        np.testing.assert_array_equal(got, ref)
    assert sorted(free.grids) == sorted(jax_grids)
    flips = 0
    for site, grid in free.grids.items():
        step = np.abs(grid.astype(np.int32) - jax_grids[site])
        assert step.max() <= 1, site
        flips += int(step.sum())
    total = sum(g.size for g in jax_grids.values())
    assert flips <= 1e-3 * total, (flips, total)
    assert _snr_db(want, ref) > 40.0


# ---- the decoder ConvFFN ---------------------------------------------------

def test_convffn_int8_matches_jax():
    """JAX's calibration and its `_ffn_quant` injected: the port's FFT
    stack records the same max-abs, runs int8 within 1e-5 of JAX's, and
    stays pad-invariant at a longer bucket."""
    import jax
    from tts_arabic_tpu.models.layers import FFTransformer as JaxFFT
    jm = JaxFFT(n_layer=2, n_head=1, d_model=64, d_head=64, d_inner=256,
                kernel_size=3, dropout=0.1, dropatt=0.1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    lens = np.asarray([24, 17])
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(lens))
    (_, _), aux = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                           mutable=["calib"])
    qt = {"decoder": {
        layer: {"ff": {"ffn_ascale": jnp.asarray(
            [float(c["ff"]["ffn_amax1"]) / 127.0,
             float(c["ff"]["ffn_amax2"]) / 127.0], jnp.float32)}}
        for layer, c in aux["calib"].items()}}
    want, _ = jm.apply({**variables, "quant": qt["decoder"]},
                       jnp.asarray(x), jnp.asarray(lens))

    sd = {}
    convert._fft_stack_t(sd, "s", variables["params"])
    port = FFTransformer(2, 1, 64, 64, 256, 3).eval()
    own = port.state_dict()
    own.update({k[2:]: torch.from_numpy(np.array(v))
                for k, v in sd.items()})
    port.load_state_dict(own)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    with torch.no_grad(), port.calibrate_ffn() as stats:
        port(xt, lt)
    for s, (layer, c) in zip(stats, sorted(aux["calib"].items())):
        for key in ("ffn_amax1", "ffn_amax2"):
            assert float(s[key]) == pytest.approx(float(c["ff"][key]),
                                                  rel=1e-5)
    assert all(layer.pos_ff.calib is None for layer in port.layers)

    scales = convert.ffn_scales_from_quant(qt)
    port.set_ffn_int8(scales)
    with torch.no_grad():
        got, _ = port(xt, lt)
        long, _ = port(torch.nn.functional.pad(xt, (0, 0, 0, 8)), lt)
    _close(got.numpy(), np.asarray(want), 1e-5)
    np.testing.assert_allclose(long[:, :24].numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)
    port.set_ffn_int8(None)
    with torch.no_grad():
        float_out, _ = port(xt, lt)
    assert not np.allclose(float_out.numpy(), got.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="FFN scales"):
        port.set_ffn_int8(scales[:1])


# ---- the pipelines ---------------------------------------------------------

def _inject(port, scales, ffn_quant=None):
    """JAX's scales into a port pipeline's int8 path."""
    port._vocode = functools.partial(port_h8.generator_apply_int8,
                                     port.vocoder, scales=scales, min_ch=64)
    if ffn_quant is not None:
        port._ffn_scales = [torch.from_numpy(np.array(s)) for s in
                            convert.ffn_scales_from_quant(ffn_quant)]


@pytest.fixture(scope="module")
def fastpitch(weights):
    """Both FastPitch pipelines, float output first, then calibrated on
    the built-in texts."""
    kw = weights["voc"]
    ref = JaxPipe(weights["fp"], **kw)
    port = PortPipe(weights["fp"], device="cpu", **kw)
    out = dict(port_float=port.tts_single(TEXT, denoise=0.0))
    out["jax_scales"] = ref.calibrate_int8()
    out["port_scales"] = port.calibrate_int8()
    out["jax_int8"], out["jax_int8_mel"] = ref.tts_single(
        TEXT, denoise=0.0, return_mel=True)
    out["port_int8"] = port.tts_single(TEXT, denoise=0.0)
    return ref, port, out


def test_fastpitch_calibrate_int8_matches_jax(fastpitch):
    ref, port, out = fastpitch
    js, ps = out["jax_scales"], out["port_scales"]
    assert port._int8_scales is ps and len(ps) == 18
    assert sorted(ps) == sorted(js)
    for k in js:
        assert ps[k] == pytest.approx(js[k], rel=1e-5), k
    want = convert.ffn_scales_from_quant(ref._ffn_quant)
    assert len(port._ffn_scales) == len(want) == 2
    for got, w in zip(port._ffn_scales, want):
        assert got.dtype == torch.float32 and got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5)
    # encode and durations stay float: the lengths do not move
    assert out["port_int8"].shape == out["port_float"].shape \
        == out["jax_int8"].shape
    assert _snr_db(out["port_float"], out["port_int8"]) < 30.0


def test_fastpitch_int8_tts_matches_jax(fastpitch):
    """With JAX's scales injected (vocoder and FFN), the port's int8
    tts_single against JAX's, one quantized stage at a time: the same
    length, the int8-FFN mel above PIPE_SNR, and the int8 generator on
    JAX's int8 mel (at a bucket, LOG_MEL_PAD past the length) above
    PIPE_SNR. Text to wave chains the two, and a mel that moved by a tie's
    rounding moves the generator's ties too: the whole wave is held by its
    length (its SNR is 26-28 dB on TEXT, 122 dB on prompts whose mels
    agree, against 21.6 dB between int8 and float)."""
    from tts_arabic_torch.infer.pipeline import LOG_MEL_PAD
    ref, port, out = fastpitch
    _inject(port, out["jax_scales"], ref._ffn_quant)
    got, got_m = port.tts_single(TEXT, denoise=0.0, return_mel=True)
    want_m = out["jax_int8_mel"]
    assert got.shape == out["jax_int8"].shape
    assert got_m.shape == want_m.shape
    assert _snr_db(want_m, got_m) > PIPE_SNR
    mels = np.full((1, want_m.shape[1] + 32, 80), LOG_MEL_PAD, np.float32)
    mels[0, : want_m.shape[1]] = want_m.T
    want = np.asarray(jax_h8.generator_apply_int8(
        ref.vocoder_vars, jnp.asarray(mels), ref.vocoder_config,
        out["jax_scales"], strategy="xla"))
    with torch.no_grad():
        got = port._vocode(torch.from_numpy(mels)).numpy()
    assert _snr_db(want, got) > PIPE_SNR


def test_fastpitch_stream_after_calibrate(fastpitch):
    """stream() takes the int8 generator and the int8 decode, as
    tts_single does: with the int8 FFN alone (the windows' MRF stages
    float) it equals tts_single within 2e-5, with both within PIPE_SNR."""
    _, port, _ = fastpitch
    vocode = port._vocode
    port._vocode = port.vocoder
    full = port.tts_single(TEXT, denoise=0.004)
    chunks = list(port.stream(TEXT, chunk_frames=48, denoise=0.004))
    np.testing.assert_allclose(np.concatenate(chunks), full, rtol=0,
                               atol=2e-5)
    port._vocode = vocode
    full = port.tts_single(TEXT, denoise=0.004)
    chunks = list(port.stream(TEXT, chunk_frames=48, denoise=0.004))
    assert len(chunks) >= 3
    streamed = np.concatenate(chunks)
    assert streamed.shape == full.shape
    assert _snr_db(full, streamed) > PIPE_SNR


def test_calibrate_after_warmup_drops_the_graphs(weights, monkeypatch):
    """Graphs captured before calibrate_int8 are dropped and captured
    again with the int8 FFN's scales (off the card the capture records
    nothing, so the dict is left empty)."""
    port = PortPipe(weights["fp"], device="cpu", **weights["voc"])
    port.warmup(batch_sizes=(1,), text_buckets=(16,), mel_buckets=(64,))
    captured = []
    monkeypatch.setattr(port.model, "capture_graphs",
                        lambda *a: captured.append(a))
    port.model._graphs[("decode", (1, 64, 64), torch.float32, False)] = 0
    port.calibrate_int8(texts=["kitAbu"], ffn=True)
    assert port.model._graphs == {}
    assert len(captured) == 1
    assert captured[0][1] is port._ffn_scales and len(captured[0][1]) == 2
    port.calibrate_int8(texts=["kitAbu"], ffn=False)  # no graphs: none
    assert len(captured) == 1 and port._ffn_scales is None


def test_quantize_argument_calibrates(weights, fastpitch):
    _, _, out = fastpitch
    port = PortPipe(weights["fp"], device="cpu", quantize="int8",
                    **weights["voc"])
    assert port._int8_scales == out["port_scales"]
    np.testing.assert_array_equal(port.tts_single(TEXT, denoise=0.0),
                                  out["port_int8"])


def test_calibrate_from_mels_matches_jax(fastpitch):
    ref, port, _ = fastpitch
    rng = np.random.default_rng(5)
    mels = [(rng.standard_normal((2, 48, 80)) - 5.0).astype(np.float32),
            (rng.standard_normal((1, 64, 80)) - 4.0).astype(np.float32)]
    want = ref.calibrate_int8(mels=mels, margin=1.2)
    got = port.calibrate_int8(mels=[torch.from_numpy(m) for m in mels],
                              margin=1.2)
    assert ref._ffn_quant is None and port._ffn_scales is None
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    one = port.calibrate_int8(mels=mels[0], margin=1.2)
    assert sorted(one) == sorted(got)


def test_int8_refusals_match_jax(weights, tmp_path):
    """Every ValueError the JAX package raises on this path."""
    import json
    with pytest.raises(ValueError, match="unknown quantize"):
        PortPipe(device="cpu", quantize="fp4")
    with pytest.raises(ValueError, match="unknown quantize"):
        JaxPipe(quantize="fp4")
    port = PortPipe(weights["fp"], device="cpu", **weights["voc"])
    with pytest.raises(ValueError, match="texts path"):
        port.calibrate_int8(mels=np.zeros((1, 16, 80), np.float32),
                            ffn=True)
    with pytest.raises(ValueError, match="min_ch"):
        port.calibrate_int8(min_ch=32, ffn=False)
    vocos = PortPipe(weights["fp"], device="cpu", vocoder_type="vocos",
                     arabic_in=False)
    with pytest.raises(ValueError, match="HiFi-GAN"):
        vocos.calibrate_int8()
    cfg = json.loads(open(weights["voc"]["vocoder_config"]).read())
    cfg.update(resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)
    path = tmp_path / "resblock2.json"
    path.write_text(json.dumps(cfg))
    rb2 = PortPipe(weights["fp"], device="cpu", vocoder_config=str(path),
                   arabic_in=False)
    with pytest.raises(ValueError, match="ResBlock1"):
        rb2.calibrate_int8()
    t2 = PortWave(weights["t2"], device="cpu", vocoder_config=str(path),
                  arabic_in=False)
    with pytest.raises(ValueError, match="ResBlock1"):
        t2.calibrate_int8()
    with pytest.raises(ValueError, match="unknown quantize"):
        PortWave(weights["t2"], device="cpu", quantize="int4")


@pytest.fixture(scope="module")
def tacotron(weights):
    kw = dict(weights["voc"])
    ref = JaxWave(weights["t2"], **kw)
    ref.model.decoder_max_step = T2_STEPS
    port = PortWave(weights["t2"], device="cpu", **kw)
    port.model.decoder_max_step = T2_STEPS
    out = dict(port_float=port.tts_single(T2_TEXT, denoise=0.0))
    out["jax_scales"] = ref.calibrate_int8()
    out["port_scales"] = port.calibrate_int8()
    return ref, port, out


def test_tacotron2_calibrate_int8_matches_jax(tacotron):
    """Calibration on the built-in texts decoded through the model; then
    JAX's scales injected: the int8 tts_single against JAX's, lengths equal
    to the float run's."""
    ref, port, out = tacotron
    js, ps = out["jax_scales"], out["port_scales"]
    assert len(ps) == 18 and sorted(ps) == sorted(js)
    for k in js:
        assert ps[k] == pytest.approx(js[k], rel=1e-4), k
    _inject(port, js)
    got = port.tts_single(T2_TEXT, denoise=0.0)
    want = ref.tts_single(T2_TEXT, denoise=0.0)
    assert got.shape == want.shape == out["port_float"].shape
    assert _snr_db(want, got) > PIPE_SNR
    assert _snr_db(out["port_float"], got) < 30.0


def test_tacotron2_stream_after_calibrate(tacotron):
    """stream() after calibrate_int8 takes the int8 generator: it holds
    against the port's own int8 tts_single(postprocess_mel=False) and
    against JAX's int8 tts_single (JAX's own stream may serve the float
    vocoder after a recalibration), each at PIPE_SNR."""
    ref, port, out = tacotron
    _inject(port, out["jax_scales"])
    full = port.tts_single(T2_TEXT, denoise=0.004, postprocess_mel=False)
    streamed = np.concatenate(list(port.stream(T2_TEXT, chunk_frames=24,
                                               denoise=0.004)))
    assert streamed.shape == full.shape
    assert _snr_db(full, streamed) > PIPE_SNR
    want = ref.tts_single(T2_TEXT, denoise=0.004, postprocess_mel=False)
    assert want.shape == streamed.shape
    assert _snr_db(want, streamed) > PIPE_SNR


def test_tacotron2_quantize_argument(weights, tacotron, monkeypatch):
    """quantize="int8" calibrates in the constructor, on the decodes of
    the built-in texts (capped at T2_STEPS, as every decode here)."""
    from tts_arabic_torch.infer import tacotron_pipeline
    init = tacotron_pipeline.Tacotron2TTS.__init__

    def capped(self, *a, **kw):
        init(self, *a, **kw)
        self.decoder_max_step = T2_STEPS
    monkeypatch.setattr(tacotron_pipeline.Tacotron2TTS, "__init__", capped)
    _, _, out = tacotron
    port = PortWave(weights["t2"], device="cpu", quantize="int8",
                    **weights["voc"])
    assert sorted(port._int8_scales) == sorted(out["port_scales"])
    for k, v in out["port_scales"].items():
        assert port._int8_scales[k] == pytest.approx(v, rel=1e-4), k
