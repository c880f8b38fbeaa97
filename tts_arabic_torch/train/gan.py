"""The adversarial recipe's critic and its mel chunks (the port's
counterpart of the JAX package's `train/gan.py`; reference
`models/common/loss.py`):

- `PatchDiscriminator`: 5 spectral-normalized 2D convs (k5, s2, LeakyReLU
  0.2) over mel chunks [N, 1, T, F] (NCHW; the JAX critic takes
  [N, T, F, 1]), returning (the flattened score, 4 feature maps)
- spectral normalization with one power iteration a forward, as the JAX
  package does it, not as `torch.nn.utils.spectral_norm` does: sigma comes
  from the detached weight, so the gradient of w / sigma is 1 / sigma
  alone, and the iteration vector `u` is explicit state that the caller
  threads (`forward` takes it and returns the advanced one) instead of a
  buffer that advances on every forward in train mode
- `extract_chunks`, `sample_chunk_params`: random fixed-length mel chunks
  (`loss.py:9-28`, `scripts/train_fp_adv.py:129-136`)
- the feature-matching loss (`loss.py:31-41`)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

CHUNK_LEN = 128         # mel frames a critic chunk


def _l2(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


class SNConv2d(nn.Module):
    """A SAME-padded 2D conv whose weight is divided by its largest singular
    value, estimated by one power iteration from `u` [out, 1]."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5,
                 stride: int = 2):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, u: torch.Tensor):
        """x [N, C_in, H, W] -> (y [N, C_out, H', W'], the advanced u)."""
        w = self.weight
        w_mat = w.detach().reshape(w.shape[0], -1)    # [out, in*k*k]
        v = _l2(w_mat.T @ u)
        u_new = _l2(w_mat @ v)
        sigma = (u_new.T @ w_mat @ v)[0, 0]
        pad = (w.shape[-1] - 1) // 2
        y = F.conv2d(x, w / sigma, self.bias, stride=self.stride,
                     padding=pad)
        return y, u_new


class PatchDiscriminator(nn.Module):
    """Mel-chunk critic (`loss.py:94-111`): convs `conv1`..`conv5` of
    cnum, 2, 4, 4, 4 x cnum channels. The power-iteration vectors live
    outside the module, as a dict {'conv<i>': u [out, 1]} (`init_critic`),
    the JAX package's 'spectral' collection."""

    def __init__(self, cnum: int = 32, in_channels: int = 1):
        super().__init__()
        chans = [cnum, 2 * cnum, 4 * cnum, 4 * cnum, 4 * cnum]
        dims = [in_channels] + chans
        for i, ch in enumerate(chans):
            setattr(self, f"conv{i + 1}", SNConv2d(dims[i], ch))
        self.n_convs = len(chans)

    def convs(self):
        return [getattr(self, f"conv{i + 1}") for i in range(self.n_convs)]

    def forward(self, x: torch.Tensor, spectral: dict):
        """x [N, 1, T, F] -> (score [N, n], fmaps (4 maps), spectral'):
        each conv starts its power iteration from `spectral`'s vector, and
        the advanced vectors come back; `spectral` is left as it is."""
        fmaps, new = [], {}
        for i, conv in enumerate(self.convs()):
            name = f"conv{i + 1}"
            x, new[name] = conv(x, spectral[name])
            x = F.leaky_relu(x, 0.2)
            if i < self.n_convs - 1:
                fmaps.append(x)
        return x.flatten(1), fmaps, new


def init_critic(critic: PatchDiscriminator, seed: int) -> dict:
    """Seeded init as the JAX critic's: conv weights N(0, 0.02), biases 0,
    drawn on the CPU; returns the iteration vectors {'conv<i>': u [out, 1]}
    (truncated normal in [-2, 2]), drawn after the weights from the same
    generator, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    spectral = {}
    with torch.no_grad():
        for conv in critic.convs():
            w = torch.randn(conv.weight.shape, generator=gen) * 0.02
            conv.weight.copy_(w)
            conv.bias.zero_()
        for i, conv in enumerate(critic.convs()):
            u = torch.empty(conv.weight.shape[0], 1)
            torch.nn.init.trunc_normal_(u, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            spectral[f"conv{i + 1}"] = u
    return spectral


def extract_chunks(mel: torch.Tensor, offsets: torch.Tensor,
                   mel_ids: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """mel [B, T, F] feature-last; offsets, mel_ids [N] -> [N, chunk_len, F]
    (`loss.py:9-28`, transposed layout).

    Frame indices follow JAX's gather, not torch indexing: a negative
    index wraps once (adds T), then every index clamps to [0, T - 1] in
    the forward, while the gradient flows only from the frames whose
    index was in [0, T) after the wrap (the gather's transpose drops the
    others). A mel shorter than the chunk gives a negative offset
    (`sample_chunk_params`), which torch indexing on the card would turn
    into a device-side assert."""
    T = mel.shape[1]
    pos = offsets[:, None] + torch.arange(chunk_len, device=mel.device)
    pos = torch.where(pos < 0, pos + T, pos)
    inside = ((pos >= 0) & (pos < T))[..., None]
    out = mel[mel_ids[:, None], pos.clamp(0, T - 1)]
    return torch.where(inside, out, out.detach())


def sample_chunk_params(generator: torch.Generator, batch_size: int,
                        mel_lens: torch.Tensor, chunk_len: int):
    """Random (mel_ids, offsets) with the reference's clamped sampling
    (`scripts/train_fp_adv.py:129-136`), drawn from `generator` on its own
    device (the step's is on the CPU, so the card and the CPU draw the
    same chunks). The offset is clipped to [0, len - chunk_len] and is
    negative where len < chunk_len, as in JAX. Returns int64 tensors on
    the generator's device."""
    dev = generator.device
    mel_ids = torch.randint(0, batch_size, (batch_size,), generator=generator,
                            device=dev)
    perc = torch.rand(batch_size, generator=generator, device=dev)
    out_lens = mel_lens.to(dev)[mel_ids].to(torch.float32)
    ofx = perc * (out_lens + chunk_len) - chunk_len / 2.0
    ofx = torch.minimum(torch.clamp(ofx, min=0.0), out_lens - chunk_len)
    return mel_ids, ofx.to(torch.int32).to(torch.int64)


def feature_match_loss(fmaps_gen, fmaps_org, mean=torch.mean) -> torch.Tensor:
    """Mean L1 between feature maps, the real side detached
    (`loss.py:31-41`); `mean` takes each map's mean (over the global
    batch's chunks under data parallelism)."""
    loss = 0.0
    for g, o in zip(fmaps_gen, fmaps_org):
        loss = loss + mean(torch.abs(g - o.detach()))
    return loss / len(fmaps_gen)


def normalize_mel_chunk(x: torch.Tensor) -> torch.Tensor:
    """Critic input scaling (`train_fp_adv.py:152-153`)."""
    return (x + 4.5) / 2.5


def critic_input(mel: torch.Tensor, mel_ids: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """The critic's [N, 1, CHUNK_LEN, F] input from mel [B, T, F]."""
    return normalize_mel_chunk(
        extract_chunks(mel, offsets, mel_ids, CHUNK_LEN))[:, None]
