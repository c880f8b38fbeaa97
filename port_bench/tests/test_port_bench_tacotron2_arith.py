"""The benchmark's frozen Tacotron2 arithmetic (`yardstick_tacotron2.py`)
held to the program's: the FLOP count equal to the port's
`eval/flops.py::tacotron2_flops`, and the weights the step bound reads
equal to the decoder's own, at the cell's configuration."""
import json

import pytest

from port_bench import harness, yardstick, yardstick_tacotron2 as y2

CONFIG = json.loads((harness.HERE / "configs" /
                     "tacotron2-gate-hifigan-v1.json").read_text())
T2 = CONFIG["tacotron2"]


@pytest.mark.parametrize("n_tokens,n_steps", [(53, 352), (118, 800),
                                              (236, 1536), (240, 3000)])
def test_tacotron2_flops(n_tokens, n_steps):
    from tts_arabic_torch.eval import flops
    from tts_arabic_torch.models.tacotron2 import Tacotron2Config
    assert (y2.tacotron2_flops(T2, n_tokens, n_steps)
            == flops.tacotron2_flops(Tacotron2Config(**T2), n_tokens,
                                     n_steps))


def test_decoder_weight_count_is_the_decoders():
    """The step bound reads every weight a decoder step reads: the
    program's `decoder_weights`, element for element."""
    import torch

    from tts_arabic_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    with torch.device("meta"):
        model = Tacotron2(Tacotron2Config(**T2))
    w = model.decoder_weights(torch.float32)
    leaves = [w["prenet"], w["attention_rnn"], w["decoder_rnn"], w["query"],
              w["v"], w["location_conv"], w["location_dense"], w["out_w"],
              w["out_b"]]
    count = sum(t.numel() for leaf in leaves
                for t in (leaf if isinstance(leaf, (list, tuple))
                          else [leaf]))
    assert y2.decoder_weight_count(T2) == count


def test_decode_step_bound():
    """At the cell's shape a bf16 step is bound by its bytes (the
    decoder's weights), and the bound reads both terms as documented."""
    B, T = 16, 240
    got = y2.decode_step_bound_s(T2, B, T, "bfloat16")
    flops_s = B * y2.decode_step_flops(T2, T) / yardstick.PEAK_FLOPS[
        "bfloat16"]
    assert got > flops_s
    weights_s = 2 * y2.decoder_weight_count(T2) / yardstick.PEAK_BYTES
    assert weights_s < got < 1.2 * weights_s
    assert y2.decode_step_bound_s(T2, B, T, "float32") > got
