"""The Wan VAE's decoder in plain float32 PyTorch: a copy of the port's
full-tensor decode (``moviigen_tpu_torch/models/vae.py::decode`` and what
it calls, commit 503dac0), which follows ``wan/modules/vae.py``'s
``Decoder3d``: causal 3D convolutions, RMS norms over channels, a
per-frame single-head attention in the middle, 2× upsampling in space
and, with a first-frame bypass, in time.

The decoder is causal in time: output frames 1 + 4(k − 1) and before
depend only on the first k latent frames. So the check decodes a prefix
of a clip's latent frames as one tensor and compares it with the same
frames of the program's (streamed) decode.

``fp8`` rounds every convolution's input and weight through float8 e4m3
first: the control, this decoder one precision below the bf16 the
pipeline decodes in.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dit import fp8_round

# the published latent normalization (wan/modules/vae.py)
LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


class Decoder:
    def __init__(self, params: dict, fp8: bool = False):
        self.p, self.fp8 = params, fp8

    def _ops(self, x, w):
        return (fp8_round(x), fp8_round(w)) if self.fp8 else (x, w)

    def conv3d(self, name, x, stride=(1, 1, 1), time_pad=None,
               space_pad=None):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        kt, kh = w.shape[2:4]
        tp = 2 * ((kt - 1) // 2) if time_pad is None else time_pad
        sp = (kh - 1) // 2 if space_pad is None else space_pad
        x = F.pad(x, (sp, sp, sp, sp, tp, 0))
        x, w = self._ops(x, w)
        return F.conv3d(x, w, None, stride) + b.view(1, -1, 1, 1, 1)

    def conv2d(self, name, x):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        bs, c, t, h, wd = x.shape
        xf = x.transpose(1, 2).reshape(bs * t, c, h, wd)
        xf, w = self._ops(xf, w)
        out = F.conv2d(xf, w, None, padding=(w.shape[2] - 1) // 2)
        out = out + b.view(1, -1, 1, 1)
        return out.reshape(bs, t, -1, h, wd).transpose(1, 2)

    def norm(self, name, x):
        c = x.shape[1]
        normed = x / x.square().sum(1, keepdim=True).sqrt().clamp_min(1e-12)
        return normed * math.sqrt(c) * self.p[name + ".gamma"].view(
            1, -1, 1, 1, 1)

    def res(self, name, x):
        h = (self.conv3d(name + ".shortcut", x)
             if name + ".shortcut.weight" in self.p else x)
        y = self.conv3d(name + ".conv1", F.silu(self.norm(name + ".norm1", x)))
        y = self.conv3d(name + ".conv2", F.silu(self.norm(name + ".norm2", y)))
        return y + h

    def attn(self, name, x):
        b, c, t, h, w = x.shape
        qkv = self.conv2d(name + ".to_qkv", self.norm(name + ".norm", x))
        qkv = qkv.transpose(1, 2).reshape(b * t, 3 * c, h * w)
        out = torch.empty((b * t, h * w, c), dtype=x.dtype, device=x.device)
        for i in range(b * t):
            q, k, v = qkv[i].t().split(c, 1)
            out[i] = torch.softmax((q @ k.t()) * c ** -0.5, -1) @ v
        out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return self.conv2d(name + ".proj", out) + x

    def up_time(self, name, x):
        first = x[:, :, :1]
        if x.shape[2] == 1:
            return first
        y = self.conv3d(name, x[:, :, 1:], time_pad=2, space_pad=0)
        b, c2, t, h, w = y.shape
        y = y.view(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
        return torch.cat([first, y.reshape(b, c2 // 2, 2 * t, h, w)], 2)

    def decode(self, z: torch.Tensor, v: dict) -> torch.Tensor:
        """Normalized latent [B, z, T', H', W'] → video [B, 3, T, 8H',
        8W'] in [-1, 1]."""
        zd = v["z_dim"]
        mean = torch.tensor(LATENT_MEAN[:zd], device=z.device).view(
            1, -1, 1, 1, 1)
        std = torch.tensor(LATENT_STD[:zd], device=z.device).view(
            1, -1, 1, 1, 1)
        h = self.conv3d("conv2", z * std + mean)
        h = self.conv3d("decoder.conv1", h)
        h = self.res("decoder.mid_res1", h)
        h = self.attn("decoder.mid_attn", h)
        h = self.res("decoder.mid_res2", h)
        for i in range(len(v["dim_mult"])):
            pre = f"decoder.up.{i}"
            for r in range(v["num_res_blocks"] + 1):
                h = self.res(f"{pre}.res.{r}", h)
            if pre + ".upsample.conv.weight" in self.p:
                if pre + ".upsample.time_conv.weight" in self.p:
                    h = self.up_time(pre + ".upsample.time_conv", h)
                h = h.repeat_interleave(2, 3).repeat_interleave(2, 4)
                h = self.conv2d(pre + ".upsample.conv", h)
        h = self.norm("decoder.head_norm", h)
        return self.conv3d("decoder.head_conv", F.silu(h)).clamp(-1.0, 1.0)


def drawn_params(seed: int, v: dict, device) -> dict:
    """The decoder's leaves drawn from the seed (fp32)."""
    from .weights import draw_group, group_specs, vae_init, vae_specs

    (group, specs), = group_specs("vae", vae_specs(v)).items()
    return draw_group(seed, "vae", group, specs, vae_init, device)
