"""Vocos vocoder family (torch counterpart of the JAX package's
`vocoder/vocos.py`): a ConvNeXt backbone and Fourier heads.

- `VocosBackbone`: embed conv k7 -> LayerNorm -> 8 x ConvNeXtBlock
  (depthwise k7 -> LN -> pointwise 1536 -> GELU -> pointwise -> layer-scale
  gamma) -> final LN (reference `models.py:26-89`, `modules.py:8-60`), with
  optional AdaLayerNorm conditioning (`modules.py:63-86`); the
  `VocosResNetBackbone` alternative (`models.py:92-118`)
- heads: `ISTFTHead` (Linear -> exp-magnitude clipped at 1e2 and phase ->
  ISTFT, `heads.py:26-69`), `IMDCTSymExpHead`, `IMDCTCosHead`
  (`heads.py:72-164`)
- `mdct` / `imdct` by FFT with twiddles (`spectral_ops.py:78-192`)
- `MelVocos`, the inference wrapper with the 22k/24k configs and the
  zero-mel denoising bias vector (`pretrained.py:34-97`), and the generic
  `Vocos` of a feature extractor, a backbone and a head
  (`pretrained.py:100-181`)

Activations are feature-last [B, T, C]. Module and parameter names follow
the reference state dict (`backbone.embed`, `backbone.convnext.{i}.dwconv`
/ `norm` / `pwconv1` / `pwconv2` / `gamma`, `backbone.norm`,
`backbone.final_layer_norm`, `head.out`), so a published MelVocos `.pth`
loads as it is. GELU is the tanh approximation, as the JAX package's
(flax's default) computes it. The spectra are complex64: cuFFT has no
bf16, so a bf16 head takes its magnitude and phase to f32 before building
the spectrum, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.mel import frame_signal, slaney_mel_filterbank
from ..audio.stft import hann, istft
from ..models.layers import init_weights, layer_norm, linear
from ..runtime.device import resolve_device


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _conv_same(x: torch.Tensor, conv: nn.Conv1d,
               dilation: int = 1) -> torch.Tensor:
    """SAME Conv1d (groups included) on feature-last x."""
    k = conv.weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), padding=dilation * (k - 1) // 2,
                 dilation=dilation, groups=conv.groups)
    return y.transpose(1, 2)


class AdaLayerNorm(nn.Module):
    """Per-class scale and shift LayerNorm (`modules.py:63-86`)."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Embedding(num_embeddings, dim)
        self.shift = nn.Embedding(num_embeddings, dim)

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor) -> torch.Tensor:
        scale = F.embedding(cond_id, self.scale.weight).to(x.dtype)
        shift = F.embedding(cond_id, self.shift.weight).to(x.dtype)
        x = F.layer_norm(x, (self.dim,), eps=1e-6)
        return x * scale[:, None, :] + shift[:, None, :]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: float,
                 adanorm_num_embeddings: Optional[int] = None):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim)
        self.norm = (AdaLayerNorm(adanorm_num_embeddings, dim)
                     if adanorm_num_embeddings
                     else nn.LayerNorm(dim, eps=1e-6))
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,),
                                              float(layer_scale_init_value)))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor, cond_id=None) -> torch.Tensor:
        residual = x
        x = _conv_same(x, self.dwconv)
        x = (self.norm(x, cond_id) if isinstance(self.norm, AdaLayerNorm)
             else layer_norm(x, self.norm))
        x = F.gelu(linear(x, self.pwconv1), approximate="tanh")
        x = linear(x, self.pwconv2)
        if self.gamma is not None:
            x = self.gamma.to(x.dtype) * x
        return residual + x


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int = 80, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 layer_scale_init_value: Optional[float] = None,
                 adanorm_num_embeddings: Optional[int] = None):
        super().__init__()
        self.input_channels = input_channels
        self.embed = nn.Conv1d(input_channels, dim, 7)
        self.norm = (AdaLayerNorm(adanorm_num_embeddings, dim)
                     if adanorm_num_embeddings
                     else nn.LayerNorm(dim, eps=1e-6))
        scale = layer_scale_init_value or 1.0 / num_layers
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(dim, intermediate_dim, scale,
                          adanorm_num_embeddings)
            for _ in range(num_layers))
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor, cond_id=None) -> torch.Tensor:
        """x [B, T, input_channels] -> [B, T, dim]."""
        x = _conv_same(x, self.embed)
        x = (self.norm(x, cond_id) if isinstance(self.norm, AdaLayerNorm)
             else layer_norm(x, self.norm))
        for block in self.convnext:
            x = block(x, cond_id)
        return layer_norm(x, self.final_layer_norm)


class VocosResBlock(nn.Module):
    """HiFi-GAN-style dilated residual block with layer scale
    (`modules.py`), no upsampling."""

    def __init__(self, dim: int, kernel_size: int = 3,
                 dilations: tuple = (1, 3, 5),
                 layer_scale_init_value: Optional[float] = None):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(dim, dim, kernel_size)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(dim, dim, kernel_size)
                                    for _ in dilations)
        self.gamma = (nn.ParameterList(
            nn.Parameter(torch.full((dim,), float(layer_scale_init_value)))
            for _ in dilations) if layer_scale_init_value else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, d in enumerate(self.dilations):
            y = F.leaky_relu(x, 0.1)
            y = _conv_same(y, self.convs1[i], d)
            y = F.leaky_relu(y, 0.1)
            y = _conv_same(y, self.convs2[i])
            if self.gamma is not None:
                y = self.gamma[i].to(y.dtype) * y
            x = x + y
        return x


class VocosResNetBackbone(nn.Module):
    def __init__(self, input_channels: int = 80, dim: int = 512,
                 num_blocks: int = 3,
                 layer_scale_init_value: Optional[float] = None):
        super().__init__()
        self.input_channels = input_channels
        self.embed = nn.Conv1d(input_channels, dim, 3)
        scale = layer_scale_init_value or 1.0 / num_blocks / 3
        self.resnet = nn.ModuleList(
            VocosResBlock(dim, layer_scale_init_value=scale)
            for _ in range(num_blocks))

    def forward(self, x: torch.Tensor, cond_id=None) -> torch.Tensor:
        x = _conv_same(x, self.embed)
        for block in self.resnet:
            x = block(x)
        return x


# --- MDCT / IMDCT -----------------------------------------------------------

def _cosine_window(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.sin(np.pi * (np.arange(n) + 0.5) / n).astype(
        np.float32)).to(device)


def mdct(audio: torch.Tensor, frame_len: int,
         padding: str = "same") -> torch.Tensor:
    """[B, T] -> [B, L, N] MDCT coefficients (`spectral_ops.py:78-131`)."""
    N = frame_len // 2
    n0 = (N + 1) / 2
    pad = frame_len // 2 if padding == "center" else frame_len // 4
    audio = F.pad(audio, (pad, pad))
    x = frame_signal(audio, frame_len, N) * _cosine_window(frame_len,
                                                           audio.device)
    dev = audio.device
    pre = torch.exp(-1j * math.pi * torch.arange(frame_len, device=dev)
                    / frame_len)
    post = torch.exp(-1j * math.pi * n0
                     * (torch.arange(N, device=dev) + 0.5) / N)
    X = torch.fft.fft(x * pre, dim=-1)[..., :N]
    return torch.real(X * post * np.sqrt(1 / N)) * np.sqrt(2)


def imdct(X: torch.Tensor, frame_len: int,
          padding: str = "same") -> torch.Tensor:
    """[B, L, N] -> [B, T] (`spectral_ops.py:134-192`)."""
    B, L, N = X.shape
    n0 = (N + 1) / 2
    dev = X.device
    Y = torch.cat([X, -torch.flip(X, dims=(-1,))], dim=-1).to(
        torch.complex64)
    pre = torch.exp(1j * math.pi * n0 * torch.arange(2 * N, device=dev) / N)
    post = torch.exp(1j * math.pi * (torch.arange(2 * N, device=dev) + n0)
                     / (2 * N))
    y = torch.fft.ifft(Y * pre, dim=-1)
    y = torch.real(y * post) * np.sqrt(N) * np.sqrt(2)
    y = y * _cosine_window(frame_len, dev)
    # overlap-add with hop N
    total = (L + 1) * N
    segs = y.reshape(B, L, 2, N)
    out = torch.zeros((B, total), dtype=y.dtype, device=dev)
    out[:, : L * N] += segs[:, :, 0].reshape(B, L * N)
    out[:, N: N + L * N] += segs[:, :, 1].reshape(B, L * N)
    pad = frame_len // 2 if padding == "center" else frame_len // 4
    return out[:, pad: total - pad]


# --- heads ------------------------------------------------------------------

class ISTFTHead(nn.Module):
    def __init__(self, dim: int = 512, n_fft: int = 1024,
                 hop_length: int = 256, padding: str = "same"):
        super().__init__()
        self.n_fft, self.hop_length, self.padding = n_fft, hop_length, padding
        self.out = nn.Linear(dim, n_fft + 2)

    def spectrum(self, x: torch.Tensor):
        """Backbone features -> (magnitude, phase) [B, n_fft//2 + 1, T]
        each, in x's dtype."""
        mag, p = linear(x, self.out).transpose(1, 2).chunk(2, dim=1)
        return torch.clamp(torch.exp(mag), max=1e2), p

    def forward(self, x: torch.Tensor, denoise_bias=None,
                denoise: float = 0.0) -> torch.Tensor:
        """x [B, T, dim] -> wave [B, T * hop] f32. With `denoise_bias`
        ([n_fft//2 + 1, 1]), the magnitude less denoise * bias, clipped to
        [0, 1e2], in f32."""
        mag, p = self.spectrum(x)
        mag = mag.float()
        if denoise_bias is not None:
            mag = torch.clamp(mag - denoise * denoise_bias.float(), 0.0, 1e2)
        S = torch.complex(mag * torch.cos(p).float(),
                          mag * torch.sin(p).float())
        return istft(S, self.n_fft, self.hop_length,
                     center=self.padding == "center")


class IMDCTSymExpHead(nn.Module):
    def __init__(self, dim: int = 512, mdct_frame_len: int = 512,
                 padding: str = "same", clip_audio: bool = False):
        super().__init__()
        self.frame_len, self.padding = mdct_frame_len, padding
        self.clip_audio = clip_audio
        self.out = nn.Linear(dim, mdct_frame_len // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.clamp(symexp(linear(x, self.out).float()), -1e2, 1e2)
        audio = imdct(y, self.frame_len, self.padding)
        return torch.clamp(audio, -1.0, 1.0) if self.clip_audio else audio


class IMDCTCosHead(nn.Module):
    def __init__(self, dim: int = 512, mdct_frame_len: int = 512,
                 padding: str = "same", clip_audio: bool = False):
        super().__init__()
        self.frame_len, self.padding = mdct_frame_len, padding
        self.clip_audio = clip_audio
        self.out = nn.Linear(dim, mdct_frame_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, p = linear(x, self.out).float().chunk(2, dim=2)
        audio = imdct(torch.clamp(torch.exp(m), max=1e2) * torch.cos(p),
                      self.frame_len, self.padding)
        return torch.clamp(audio, -1.0, 1.0) if self.clip_audio else audio


# --- wrappers ---------------------------------------------------------------

CONFIG_22K = {"sample_rate": 22050, "n_mels": 80, "dim": 512,
              "intermediate_dim": 1536, "num_layers": 8, "n_fft": 1024,
              "hop_length": 256, "padding": "same"}
CONFIG_24K = {"sample_rate": 24000, "n_mels": 100, "dim": 512,
              "intermediate_dim": 1536, "num_layers": 8, "n_fft": 1024,
              "hop_length": 256, "padding": "center"}


class MelVocosModule(nn.Module):
    """Backbone + ISTFT head with the spectral denoising fused into the
    head (`pretrained.py:34-97`). mel is feature-last [B, T, n_mels]."""

    def __init__(self, n_mels: int = 80, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256,
                 padding: str = "same"):
        super().__init__()
        self.n_mels = n_mels
        self.backbone = VocosBackbone(n_mels, dim, intermediate_dim,
                                      num_layers)
        self.head = ISTFTHead(dim, n_fft, hop_length, padding)

    def forward(self, mel: torch.Tensor, denoise_bias=None,
                denoise: float = 0.0) -> torch.Tensor:
        return self.head(self.backbone(mel), denoise_bias, denoise)

    def bias_vector(self, n_frames: int = 88) -> torch.Tensor:
        """Magnitude spectrum of the first frame from a zero mel
        (`pretrained.py:59-71`): [n_fft//2 + 1, 1] f32."""
        dev = self.head.out.weight.device
        zero = torch.zeros((1, n_frames, self.n_mels), device=dev)
        mag, _ = self.head.spectrum(self.backbone(zero))
        return mag[0, :, 0:1].float()


def load_vocos_state(module: nn.Module, sd: dict) -> nn.Module:
    """A reference Vocos state dict into `module`: every parameter of
    `module` must be in it; the reference's extra buffers (its
    feature extractor's filterbank, its ISTFT window) are skipped."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"Vocos state dict lacks {missing[:4]}")
    module.load_state_dict({k: torch.as_tensor(np.asarray(sd[k]))
                            for k in own}, strict=True)
    return module


def init_vocos(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (`models.layers.init_weights`), with each
    AdaLayerNorm back at scale one and shift zero, as the reference
    initializes it."""
    init_weights(module, seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, AdaLayerNorm):
                mod.scale.weight.fill_(1.0)
                mod.shift.weight.zero_()
    return module


def _reference_sd(path) -> dict:
    from ..models.convert import load_reference_pth
    sd, _ = load_reference_pth(path)
    return sd


@dataclasses.dataclass
class MelVocos:
    """Inference wrapper (reference `MelVocos`): channel-first mel [B,
    n_mels, T] in, wave out, with a denoising strength. Runs on the card
    unless `device="cpu"`."""
    config_name: str = "22k"
    sd_path: Optional[str] = None
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        cfg = {"22k": CONFIG_22K, "24k": CONFIG_24K}[self.config_name]
        self.sample_rate = cfg["sample_rate"]
        self.module = MelVocosModule(**{k: v for k, v in cfg.items()
                                        if k != "sample_rate"})
        if self.sd_path:
            load_vocos_state(self.module, _reference_sd(self.sd_path))
        else:
            init_vocos(self.module, self.seed)
        self.device = resolve_device(self.device)
        self.module.to(self.device).eval()
        with torch.no_grad():
            self.bias_vec = self.module.bias_vector()

    @torch.no_grad()
    def __call__(self, mel, denoise: float = 0.0) -> np.ndarray:
        """mel [B, n_mels, T] or [n_mels, T] -> wave [B, T * hop]."""
        mel = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)
        if mel.dim() == 2:
            mel = mel[None]
        wave = self.module(mel.transpose(1, 2), self.bias_vec, float(denoise))
        return wave.cpu().numpy()


# --- generic Vocos (reference `Vocos.from_hparams/from_pretrained`) ----------

@dataclasses.dataclass(frozen=True)
class MelSpectrogramFeatures:
    """Vocos mel feature extractor (reference `MelSpectrogramFeatures`,
    feature_extractors.py:28-64): HTK-scale unnormalized mel (torchaudio's
    defaults), power-1 magnitude, log clipped at 1e-7."""
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    padding: str = "center"

    def __call__(self, audio) -> torch.Tensor:
        """audio [..., T] (numpy or tensor) -> log-mel [..., n_mels,
        frames] f32 on the audio's device."""
        x = torch.as_tensor(np.asarray(audio, np.float32)
                            if not isinstance(audio, torch.Tensor)
                            else audio).float()
        pad = (self.n_fft // 2 if self.padding == "center"
               else (self.n_fft - self.hop_length) // 2)
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode="reflect").reshape(*lead, -1)
        frames = frame_signal(x, self.n_fft, self.hop_length) * hann(
            self.n_fft, x.device)
        mag = torch.abs(torch.fft.rfft(frames, n=self.n_fft, dim=-1))
        basis = torch.from_numpy(slaney_mel_filterbank(
            self.sample_rate, self.n_fft, self.n_mels, norm=None,
            htk=True)).to(x.device)
        mel = torch.einsum("mf,...tf->...mt", basis, mag)
        return torch.log(torch.clamp(mel, min=1e-7))


class _VocosModel(nn.Module):
    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features [B, T, C] feature-last -> wave [B, T * hop]."""
        return self.head(self.backbone(features))


_VOCOS_CLASSES = {
    "VocosBackbone": VocosBackbone,
    "VocosResNetBackbone": VocosResNetBackbone,
    "ISTFTHead": ISTFTHead,
    "IMDCTSymExpHead": IMDCTSymExpHead,
    "IMDCTCosHead": IMDCTCosHead,
    "MelSpectrogramFeatures": MelSpectrogramFeatures,
}


def _instantiate(spec):
    name = spec["class_path"].rsplit(".", 1)[-1]
    if name not in _VOCOS_CLASSES:
        raise ValueError(f"unsupported Vocos component {spec['class_path']}")
    return _VOCOS_CLASSES[name](**(spec.get("init_args") or {}))


@dataclasses.dataclass
class Vocos:
    """Generic Vocos inference wrapper built from a reference-format hparams
    YAML (reference `Vocos.from_hparams` / `from_pretrained`,
    pretrained.py:100-181): feature extractor + backbone + head, chosen by
    class name. The YAML is read by the port's own reader
    (`runtime.config.parse_yaml`)."""
    feature_extractor: MelSpectrogramFeatures
    module: _VocosModel
    device: torch.device

    @classmethod
    def from_hparams(cls, config_path, state_dict_path=None, seed: int = 0,
                     device=None) -> "Vocos":
        """Seeded weights (`init_vocos`) without a state
        dict; a state dict loads into the ConvNeXt VocosBackbone only, as
        the JAX package's importer reads it. Runs on the card unless
        `device="cpu"`."""
        import pathlib

        from ..runtime.config import parse_yaml
        config = parse_yaml(pathlib.Path(config_path).read_text())
        feature_extractor = _instantiate(config["feature_extractor"])
        backbone = _instantiate(config["backbone"])
        module = _VocosModel(backbone, _instantiate(config["head"]))
        if state_dict_path is not None:
            if not isinstance(backbone, VocosBackbone):
                raise ValueError(
                    "state-dict import is supported for the ConvNeXt "
                    "VocosBackbone only")
            load_vocos_state(module, _reference_sd(state_dict_path))
        else:
            init_vocos(module, seed)
        dev = resolve_device(device)
        return cls(feature_extractor, module.to(dev).eval(), dev)

    @classmethod
    def from_pretrained(cls, repo_id: str, revision=None, device=None):
        """Hugging Face hub loader (network-gated, as the reference's)."""
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as e:
            raise RuntimeError(
                "from_pretrained needs huggingface_hub; download "
                "config.yaml + pytorch_model.bin manually and use "
                "from_hparams(config, state_dict_path)") from e
        config_path = hf_hub_download(repo_id, "config.yaml",
                                      revision=revision)
        model_path = hf_hub_download(repo_id, "pytorch_model.bin",
                                     revision=revision)
        return cls.from_hparams(config_path, model_path, device=device)

    @torch.no_grad()
    def decode(self, features) -> np.ndarray:
        """features [B, C, T] channel-first (reference layout) -> wave."""
        x = torch.as_tensor(np.asarray(features, np.float32)
                            if not isinstance(features, torch.Tensor)
                            else features).to(self.device)
        return self.module(x.transpose(-1, -2).float()).cpu().numpy()

    @torch.no_grad()
    def __call__(self, audio) -> np.ndarray:
        """Copy-synthesis: waveform [B, T] -> mel features -> waveform
        (reference `Vocos.forward`, pretrained.py:148-164)."""
        audio = torch.as_tensor(np.asarray(audio, np.float32)).to(self.device)
        return self.decode(self.feature_extractor(audio))
