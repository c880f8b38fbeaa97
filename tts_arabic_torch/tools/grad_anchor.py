"""How far a small HiFi-GAN generator's gradients lie from float64, by the
ResBlock forward that feeds them.

    python -m tts_arabic_torch.tools.grad_anchor [--device cuda|cpu]
        [--seeds 0,1,...]

The loss and generator of `tests/test_torch_port_cuda.py::test_generator_
gradient_reaches_every_parameter_on_the_card` (HiFi-GAN V1's kernels on
256 initial channels, seeded, mel [2, 12, 80], sum(wave * r); the test's
inputs are seed 0's, other seeds draw other mel and r), TF32 off.
The float64 reference runs on the CPU with the plain ResBlocks. On the
device the gradient runs three times, each time through
`ResBlock1Function` (plain f32 recompute in the backward), with the
ResBlocks' forward from: `resblock1` (the kernels on a card, the plain
version on the CPU); the plain version in float64, rounded to f32; the
plain version in f32. For each it prints the distance of all the
gradients together from float64, as a share of their norm (the test
holds it to 1e-4), and the parameters that hold most of it.
"""
from __future__ import annotations

import argparse
import contextlib
from unittest import mock

import torch

from ..models.layers import init_weights
from ..ops import resblock as rb
from ..vocoder import hifigan


def _generator(device, seed: int = 1):
    return init_weights(hifigan.Generator(hifigan.HiFiGANConfig(
        upsample_initial_channel=256)), seed).to(device)


def _f64_rounded(x, w1, b1, w2, b2, k, dilations):
    return rb.resblock1_plain(*(t.double() for t in (x, w1, b1, w2, b2)),
                              k, dilations).float()


def _report(device, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    mel = torch.randn((2, 12, 80), generator=g)
    r = torch.randn((2, 12 * 256), generator=g)
    exact = _generator("cpu").double()
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        ((exact(mel.double()) * r.double()).sum()).backward()
    want = {n: p.grad for n, p in exact.named_parameters()}
    forwards = (("resblock1", None), ("float64, rounded", _f64_rounded),
                ("plain f32", rb.resblock1_plain))
    for label, forward in forwards:
        gen = _generator(device)
        patch = (mock.patch.object(rb, "_forward", forward) if forward
                 else contextlib.nullcontext())
        with patch:
            ((gen(mel.to(device)) * r.to(device)).sum()).backward()
        rows = sorted(((float((p.grad.double().cpu() - want[n]).norm()), n,
                        float(want[n].norm()))
                       for n, p in gen.named_parameters()), reverse=True)
        share = (sum(d * d for d, _, _ in rows)
                 / sum(w * w for _, _, w in rows)) ** 0.5
        print(f"seed {seed}, {label}: {share:.3e} of the gradients' norm "
              "from float64 | "
              "most: " + "; ".join(f"{n} {d:.2e} of {w:.2e}"
                                    for d, n, w in rows[:4]), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds of the mel and r draws")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in map(int, args.seeds.split(",")):
        _report(device, seed)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(device), flush=True)

if __name__ == "__main__":
    main()
