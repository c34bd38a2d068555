"""chip_smoke.py `make_rgb`'s content on the card: per component a sine of
10 cycles across the width times a ramp from -1 to 1 down the height, at
0.4 of the 8-bit range around its middle, the phase flipped on every other
component, plus Gaussian sensor noise."""

import math

import torch


def make(height, width, components, gen, device, noise_sigma):
    f64 = torch.float64
    x = torch.arange(width, device=device, dtype=f64)
    y = torch.arange(height, device=device, dtype=f64)
    sine = torch.sin(2 * math.pi * 10 * x / max(width - 1, 1))
    ramp = -1.0 + 2.0 * y / max(height - 1, 1)
    planes = [127.5 + (102.0 * (-1) ** c * sine)[None, :] * ramp[:, None]
              for c in range(components)]
    field = torch.stack(planes, dim=-1)
    noise = torch.randn(field.shape, generator=gen, device=device,
                        dtype=torch.float32)
    return field + noise_sigma * noise.to(f64)
